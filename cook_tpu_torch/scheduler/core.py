"""Scheduler composition: rank, match and rebalance cycles, status
handling, kill fan-out, the fairness ledger.

Port of `cook_tpu/scheduler/core.py`: `SchedulerConfig` (its `match`,
`rebalancer`, columnar-index, encode-cache, flight-recorder, device-
telemetry, speculation, predictor and backfill fields, with the
reference's defaults) and a `Scheduler` with `rank_cycle` (the columnar
branch, `ranking_columnar.rank_pool_columnar` over
`models/columnar.ColumnarJobIndex`, or `ranking.rank_pool` with
`use_columnar_index=False` or an active backfill term; sampling the
fairness observatory and reporting the DRU solve's padded shape to the
telemetry), `match_cycle` (a flight-recorder cycle record per match, the
encode cache and the telemetry passed to the matcher; honouring and
releasing the rebalancer's host reservations and gang admission's
`gang:<group>` ones; the per-user launch rate limit,
`user_launch_rate_per_minute`, filtering the considerable window and
spent through after the match), the multi-pool passes
`match_cycle_all_pools` (pool-batched, matcher.match_pools_batched) and
`match_cycle_pipelined` (scheduler/pipeline.py, async launches;
`drain_launches`), `rebalance_cycle` (the victim search on
the device, the preemption ledger and the cycle record's preemptions,
`_transact_preemption`, host reservations for multi-victim decisions,
then `_gang_admission_cycle`: topology-aware drain-vs-kill admission of
waiting gangs, scheduler/gang.py), `handle_status_update` and `_on_event`
(completions from the backend into the store's state machine,
kill-on-complete fan-out, wasted-work accounting of kills the rebalancer
did not make), `_make_task_id`, `_make_launch_filter` and `_cache_spare`.
With `MatchConfig.device_residency` or `quantized` the scheduler owns a
`device_state.DeviceResidentState` (subscribed to the encode cache, its
parity guard registered with the quality monitor) and hands it to the
rank cycle (resident DRU columns, under `device_residency`) and to every
match path; with `RebalancerParams.resident` it owns one
`device_state.ResidentRows` mirror per pool for the rebalancer's victim
tensors (`_rebalance_mirror`).
With `speculation` or a positive `backfill_weight` the scheduler owns a
runtime predictor (`prediction.QuantileRuntimePredictor`, fed from the
store's completions; gang admission reads its drain ETAs and the
estimated-completion constraint its runtimes); with `backfill_weight`
the rank cycle runs `ranking.rank_pool` with the predicted-duration term
even when the columnar index is on (`_backfill_active`); with
`speculation` a `prediction.CycleSpeculator` dispatches cycle N+1's solve
at the end of each match cycle (`_dispatch_speculation`, serial and
pipelined) and commits or drops it at the next cycle's start
(`_speculation_commit`: a hit launches its pre-solved assignment, a drop
solves fresh on the same device).
With `SchedulerConfig.elastic` enabled the scheduler owns the elastic
capacity plane (`elastic/planner.CapacityPlanner`, on the scheduler's
device, committing through the `txn=` pipeline or an in-memory one):
`elastic_cycle` runs one planning interval over the ranked queues, the
rebalance cycle passes `reclaim_for` as the victim search's reclaimer
(loaned capacity comes home before anyone is preempted), and every
cycle record carries the plan id in force (`elastic_plan`).
The diagnosis and overload layers ride along as in the reference: a
`obs/profiling.ProfileCapturer` (`torch.profiler`, `profile_dir`), an
`obs/incident.IncidentRecorder` (`incident_capacity`,
`incident_cooldown_s`, `incident_dir`, `auto_profile`) fed by every
telemetry health verdict (`telemetry.health_observer`) and collecting the
span-ring trace, the armed faults, the last cycle records and the
fairness snapshot, and a `faults/reactions.AdmissionController` whose
clamp shrinks each pool's considerable window while its overload signal
holds (serial pass and multi-pool prologue; inert until a caller sets
`overload_fn`).
The host-side duties of a leader come with it, as in the reference: a
`plugins.PluginRegistry` (submission plugins are the REST layer's; here its
launch filters join the considerable-job filter and its completion
handlers see every finished instance), the effect gate `active` (a hot
standby's scheduler only maintains indexes), `add_cluster` for clusters
created over REST, the `monitor.JobLifecycleTracker` feeding the job-
latency histograms, and the task-lifecycle monitors `kill_lingering_tasks`,
`kill_stragglers`, `kill_cancelled_tasks` and `reconcile`.

The scheduler's device is resolved once, here, through `device.resolve`:
CUDA unless the caller passes `device="cpu"`.
"""
from __future__ import annotations

import functools
import statistics
import itertools
import logging
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Optional, Sequence, Union

import torch

from cook_tpu_torch.cluster.base import (
    ComputeCluster,
    safe_pool_offers,
    scan_pool_offers,
    wait_all_launches,
)
from cook_tpu_torch.device import resolve
from cook_tpu_torch.elastic.planner import CapacityPlanner, ElasticParams
from cook_tpu_torch.models.columnar import ColumnarJobIndex
from cook_tpu_torch.models.entities import InstanceStatus, Job, Pool, Resources
from cook_tpu_torch.models.reasons import REASONS_BY_CODE
from cook_tpu_torch.faults.reactions import AdmissionController
from cook_tpu_torch.models.store import Event, JobStore
from cook_tpu_torch.obs import data_plane
from cook_tpu_torch.obs.compile_observatory import shape_signature
from cook_tpu_torch.obs.device_monitor import device_memory_stats
from cook_tpu_torch.obs.fairness import FairnessObservatory
from cook_tpu_torch.obs.incident import (
    IncidentRecorder,
    add_default_collectors,
)
from cook_tpu_torch.obs.profiling import ProfileCapturer
from cook_tpu_torch.obs.telemetry import DeviceTelemetry
from cook_tpu_torch.scheduler.device_state import (
    DeviceResidentState,
    ResidentRows,
)
from cook_tpu_torch.scheduler.encode_cache import EncodeCache
from cook_tpu_torch.scheduler.flight_recorder import (
    EXCEEDS_POOL_CAPACITY,
    NULL_CYCLE,
    FlightRecorder,
    PreemptionRecord,
)
from cook_tpu_torch.scheduler.gang import (
    GANG_RESERVATION_PREFIX,
    GangAdmission,
    gang_reservation_tag,
    plan_gang_admissions,
)
from cook_tpu_torch.scheduler.matcher import (
    MatchConfig,
    MatchOutcome,
    PoolMatchState,
    finalize_pool_match,
    match_pool,
    match_pools_batched,
    problem_shape,
    record_considered,
    solve_backend,
    topology_block_width,
)
from cook_tpu_torch.scheduler.monitor import JobLifecycleTracker
from cook_tpu_torch.scheduler.pipeline import (
    PipelineParams,
    match_pools_pipelined,
)
from cook_tpu_torch.scheduler.plugins import PluginRegistry
from cook_tpu_torch.scheduler.prediction import (
    CycleSpeculator,
    QuantileRuntimePredictor,
)
from cook_tpu_torch.scheduler.ranking import (
    RankedQueue,
    offensive_job_filter,
    rank_pool,
)
from cook_tpu_torch.scheduler.ranking_columnar import rank_pool_columnar
from cook_tpu_torch.scheduler.ratelimit import TokenBucketRateLimiter
from cook_tpu_torch.scheduler.rebalancer import (
    Decision,
    RebalancerParams,
    rebalance_pool,
)
from cook_tpu_torch.utils.metrics import global_registry

log = logging.getLogger(__name__)


@dataclass
class SchedulerConfig:
    match: MatchConfig = field(default_factory=MatchConfig)
    rebalancer: RebalancerParams = field(default_factory=RebalancerParams)
    # columnar host-side state: O(delta) rank-cycle encoding
    use_columnar_index: bool = True
    # host-encode cache (scheduler/encode_cache.py): incremental
    # encode_nodes + feasibility rows keyed by offer-set fingerprint,
    # store-event invalidated — an unchanged pool re-encodes O(delta)
    use_encode_cache: bool = True
    # flight recorder: bounded ring of per-cycle decision records
    # (flight_recorder.py); 0 disables
    flight_recorder_capacity: int = 512
    # device telemetry (cook_tpu_torch/obs/): compile observatory, sampled
    # CPU shadow-solve quality monitor, solve-latency baselines,
    # device-memory gauges — the health verdict's substrate.  False
    # disables.
    device_telemetry: bool = True
    # shadow-solve every Nth solvable match cycle per pool (0 keeps the
    # telemetry but never shadow-solves)
    quality_sample_every: int = 25
    # per-user launch rate limit (quota.clj:118 + rate_limit.clj): a token
    # bucket per (user, pool) refilled at this many launches a minute,
    # holding `user_launch_burst` tokens (0 = the rate); 0 disables
    user_launch_rate_per_minute: float = 0.0
    user_launch_burst: float = 0.0
    # pipelined multi-pool match pass (scheduler/pipeline.py): overlap
    # host encode/launch with the device solve; depth = max in-flight
    # solves (2 = double-buffered)
    pipeline_depth: int = 2
    # fan backend launches out on the per-cluster launch executors during
    # the pipelined pass (kills still exclude via the kill-lock)
    async_launch: bool = True
    # prediction-assisted speculative cycles (scheduler/prediction.py):
    # while cycle N's launches drain, cycle N+1's solve is pre-encoded
    # and pre-dispatched against the predicted offer set; it commits at
    # cycle N+1 start only if the stamped epoch is unchanged (a stale
    # speculation is dropped, never repaired).  Off by default.
    speculation: bool = False
    # how far ahead (store-clock ms) a running task's predicted finish
    # may sit and still be assumed complete by the speculative solve;
    # the simulator pins this to its cycle_ms
    speculation_horizon_ms: float = 30_000.0
    # runtime predictor (per-(user, command-fingerprint) rolling
    # quantiles)
    predictor_quantile: float = 0.75
    predictor_window: int = 64
    predictor_min_samples: int = 3
    # predicted-duration backfill (ops/dru.py): a bounded scoring term
    # added to each pending task's DRU before the global order sort, so
    # predicted-short jobs backfill ahead at near-equal fairness.  0
    # disables (rank order untouched — the default)
    backfill_weight: float = 0.0
    # predicted duration that saturates the backfill term (fraction
    # clamps to 1 at/above this)
    backfill_norm_ms: float = 600_000.0
    # incident observatory (obs/incident.py): every ok->degraded health
    # transition snapshots an evidence bundle (verdict, cycle records,
    # span-ring chrome trace, armed faults, fairness) into a bounded
    # ring; incident_dir persists bundles to disk
    incident_capacity: int = 32
    incident_cooldown_s: float = 30.0
    incident_dir: str = ""
    # automatic device-profile capture (obs/profiling.ProfileCapturer)
    # riding the incident capture for latency-shaped reasons; opt-in:
    # the profiler is process-global and a capture costs real overhead
    auto_profile: bool = False
    profile_dir: str = ""
    # elastic capacity plane (cook_tpu_torch/elastic/): pool-to-pool
    # capacity loaning with durable ledger deltas and reclaim-before-
    # preemption.  Disabled by default; enable via
    # ElasticParams(enabled=True)
    elastic: ElasticParams = field(default_factory=ElasticParams)


class Scheduler:
    """One leader's scheduling brain: host-side orchestration around the
    device solves."""

    def __init__(
        self,
        store: JobStore,
        clusters: Sequence[ComputeCluster],
        config: Optional[SchedulerConfig] = None,
        *,
        plugins=None,
        device: Optional[Union[str, torch.device]] = None,
        txn=None,
    ):
        self.store = store
        self.clusters = list(clusters)
        self.config = config or SchedulerConfig()
        self.device = resolve(device)
        self.plugins = plugins or PluginRegistry()
        self._launch_filter_cache: dict = {}
        self.launch_rate_limiter = None
        if self.config.user_launch_rate_per_minute > 0:
            self.launch_rate_limiter = TokenBucketRateLimiter(
                tokens_replenished_per_minute=(
                    self.config.user_launch_rate_per_minute),
                bucket_size=(self.config.user_launch_burst
                             or self.config.user_launch_rate_per_minute),
                clock=store.clock,
            )
        self._task_seq = itertools.count()
        # effect gate: on a hot standby the store's event feed carries
        # REPLICATED transactions — the leader already executed their side
        # effects (kill fan-out, completion plugins), so a passive
        # scheduler only maintains indexes.  components.start_leader_duties
        # flips this at promotion.
        self.active = True
        self.pool_queues: dict[str, RankedQueue] = {}
        self.pool_match_state: dict[str, PoolMatchState] = {}
        self.last_unmatched_offers: dict[str, dict[str, Resources]] = {}
        # pool -> hostname -> (attributes, cluster location) of the last scan
        self.last_host_info: dict[str, dict[str, tuple[dict, str]]] = {}
        self.placement_failures: dict[str, str] = {}  # job uuid -> reason text
        # rebalancer host reservations: hostname -> reserving job uuid
        # (reserve-hosts!, rebalancer.clj:419), or gang:<group> for a
        # gang admission's hosts (any member of the group may claim them)
        self.host_reservations: dict[str, str] = {}
        # the last rebalance cycle's gang admissions (GangAdmission.to_json)
        self.last_gang_admissions: list[dict] = []
        # accumulating hostname -> attributes cache: fully-occupied hosts
        # emit no offers, but their attrs are still needed to count running
        # group members for balanced-host placement (constraints.clj:600).
        # LRU-bounded: long-lived autoscaled clusters mint unique node
        # names forever
        self.host_attr_cache: OrderedDict[str, dict] = OrderedDict()
        self.host_attr_cache_max = 100_000
        self.metrics: dict[str, float] = {}
        # fairness observatory (obs/fairness.py): per-user DRU
        # trajectories fed from rank_cycle, the preemption ledger fed
        # from rebalance_cycle, wasted-work rollups recovered from the
        # store's terminal instances
        self.fairness = FairnessObservatory(clock=store.clock)
        self.fairness.recover(store)
        self.columnar = (ColumnarJobIndex(store)
                         if self.config.use_columnar_index else None)
        self.encode_cache = (EncodeCache(store)
                             if self.config.use_encode_cache else None)
        # device-resident match state (scheduler/device_state.py): per-pool
        # encode tensors stay on the device across cycles with O(delta)
        # in-place updates; also hosts the quantization parity guard, so
        # it exists whenever either knob is on (the observatory reference
        # is set after telemetry below)
        self.device_state = None
        if self.config.match.device_residency or self.config.match.quantized:
            self.device_state = DeviceResidentState(
                encode_cache=self.encode_cache, device=self.device,
                parity_floor=self.config.match.quantization_parity_floor)
        # runtime prediction + speculative cycles (prediction.py): the
        # predictor feeds from instance completions (gang admission's
        # drain ETAs read it too); the speculator pre-dispatches cycle
        # N+1's solve while cycle N drains
        self.predictor = None
        self.speculator = None
        if self.config.speculation or self.config.backfill_weight > 0:
            self.predictor = QuantileRuntimePredictor(
                quantile=self.config.predictor_quantile,
                window=self.config.predictor_window,
                min_samples=self.config.predictor_min_samples,
            ).attach(store)
        if self.config.speculation:
            self.speculator = CycleSpeculator(
                store, self.clusters, self.predictor, device=self.device,
                horizon_ms=self.config.speculation_horizon_ms,
                encode_cache=self.encode_cache,
                device_state=self.device_state,
            )
        # pool -> the rebalancer's resident row mirror (_rebalance_mirror)
        self._rebalance_mirrors: dict[str, ResidentRows] = {}
        # per-cycle flight recorder: structured decision records
        self.recorder = (
            FlightRecorder(capacity=self.config.flight_recorder_capacity)
            if self.config.flight_recorder_capacity > 0 else None)
        # device telemetry: every rank/match/rebalance solve reports its
        # (op, padded shape, backend) here; the health verdict folds it.
        # Memory stats are this scheduler's device's (none on the CPU)
        self.telemetry = None
        if self.config.device_telemetry:
            self.telemetry = DeviceTelemetry(
                quality_sample_every=self.config.quality_sample_every,
                memory_stats_fn=functools.partial(device_memory_stats,
                                                  self.device),
            )
        if self.device_state is not None and self.telemetry is not None:
            # compile accounting for the update/gather programs, and the
            # quantization parity guard riding every shadow-solve sample
            # (one wiring site covers the serial, batched and pipelined
            # paths)
            self.device_state.observatory = self.telemetry.observatory
            self.telemetry.quality.add_listener(
                self.device_state.note_quality)
        elif self.config.match.quantized:
            # the parity guard rides the QualityMonitor's shadow-solve
            # samples; without device telemetry no samples ever flow, so
            # bf16 drift would go undetected AND undemoted — say so
            log.warning(
                "MatchConfig.quantized is on but device_telemetry is "
                "off: the QualityMonitor parity guard cannot run, so "
                "bf16 packing drift will never demote to f32 — enable "
                "device_telemetry or disable quantized")
        # incident observatory + profile capture: the scheduler
        # contributes cycle records, the span-ring chrome trace, the armed
        # fault schedule and the fairness snapshot as bundle evidence
        self.profiler = ProfileCapturer(
            base_dir=self.config.profile_dir or None)
        self.incidents = add_default_collectors(IncidentRecorder(
            capacity=self.config.incident_capacity,
            cooldown_s=self.config.incident_cooldown_s,
            dir=self.config.incident_dir or None,
            profiler=self.profiler,
            auto_profile=self.config.auto_profile))
        if self.recorder is not None:
            self.incidents.add_collector(
                "cycles", lambda: self.recorder.records_json(limit=50))
        if self.telemetry is not None:
            self.telemetry.health_observer = self.incidents.observe
        self.incidents.add_collector("fairness", self.fairness.collector)
        # overload admission control: while `overload_fn` reports
        # overload, every pool's considerable window shrinks x0.95 a
        # cycle toward a floor, restoring as it clears
        self.admission = AdmissionController()
        # pool -> the last rank cycle's wall, credited to the next match
        # cycle's record
        self._last_rank_s: dict[str, float] = {}
        # elastic capacity plane: capacity deltas commit through the txn
        # pipeline (a journal-backed log when the caller passes one; a bare
        # Scheduler gets an in-memory pipeline with the same op registry)
        self.txn = txn
        self.elastic = None
        if self.config.elastic.enabled:
            from cook_tpu_torch.txn import TransactionLog

            self.txn = txn or TransactionLog(store)
            self.elastic = CapacityPlanner(
                store, self.clusters, self.txn, self.config.elastic,
                telemetry=self.telemetry, device=self.device)
        # effect-gated like _on_event: a standby applying replicated
        # events must not observe apply-time latencies into the SLO
        # histograms
        self.lifecycle = JobLifecycleTracker(store,
                                             enabled=lambda: self.active)
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

    def add_cluster(self, cluster: ComputeCluster) -> None:
        """Attach a dynamically-created compute cluster (reference: dynamic
        cluster config insertion, compute_cluster.clj:450-530)."""
        if self.cluster_by_name(cluster.name) is not None:
            raise ValueError(f"cluster {cluster.name} already exists")
        if hasattr(cluster, "status_callback"):
            cluster.status_callback = self.handle_status_update
        self.clusters.append(cluster)

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
        (monitor-tx-report-queue, scheduler.clj:378), instance-completion
        plugin dispatch (plugins/definitions.clj:44) and wasted-work
        accounting."""
        if not self.active:
            return
        if event.kind == "instance/status" and event.data["status"] in (
            "success", "failed"
        ):
            job = self.store.jobs.get(event.data["job"])
            inst = self.store.instances.get(event.data["task_id"])
            if job is not None and inst is not None:
                self.plugins.on_completion(job, inst)
                self._note_wasted_work(job, inst)
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

    def _note_wasted_work(self, job, inst) -> None:
        """Mea-culpa wasted-work accounting for NON-rebalancer kills
        (e.g. the backing cluster preempted the container, reason
        `container-preempted`).  Rebalancer preemptions are accounted at
        decision time by rebalance_cycle -> fairness.record_decisions,
        and their instance/status event lands here too — skip them or
        the wasted seconds double-count."""
        if inst.status != InstanceStatus.FAILED or inst.reason_code is None:
            return
        reason = REASONS_BY_CODE.get(inst.reason_code)
        if (reason is None or not reason.mea_culpa
                or reason.name == "preempted-by-rebalancer"):
            return
        end_ms = inst.end_time_ms or self.store.clock()
        wasted_s = max(0.0, (end_ms - inst.start_time_ms) / 1000.0)
        self.fairness.note_kill(job.pool, job.user, inst.task_id,
                                wasted_s, reason=reason.name)

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

    def _offensive_filter(self, pool: Pool):
        """The pool's current offensive-job filter (or None)."""
        limits_active, max_mem, max_cpus, max_gpus = \
            self._pool_capacity_probe(pool)
        return (offensive_job_filter(max_mem, max_cpus, max_gpus)
                if limits_active else None)

    @property
    def _backfill_active(self) -> bool:
        return self.config.backfill_weight > 0 and self.predictor is not None

    def _pool_store(self, pool: Pool):
        """The store a per-pool cycle should read: a sharded store
        exposes `store_for_pool`, pinning the cycle to the pool's own
        shard — one snapshot, no facade fan-out and no cross-shard lock
        traffic mid-cycle.  Plain JobStores return themselves."""
        pinned = getattr(self.store, "store_for_pool", None)
        if pinned is None:
            return self.store
        from cook_tpu_torch.shard.router import MisroutedKey

        try:
            return pinned(pool.name)
        except MisroutedKey:
            # a pool this process does not serve: the facade raises the
            # precise error at the access site
            return self.store

    def rank_cycle(self, pool: Pool) -> RankedQueue:
        """Rank the pool's pending jobs, through the columnar index when
        it is on (and no backfill term is active), quarantining jobs no
        host in the pool could ever hold (the offensive-job filter,
        scheduler.clj:2198-2257)."""
        t_rank = time.perf_counter()
        limits_active, max_mem, max_cpus, max_gpus = \
            self._pool_capacity_probe(pool)
        # DRU-column residency rides the match knob: with residency on,
        # the rank cycle's task columns reuse their resident device
        # copies when content is unchanged (device_state.resident_array)
        dru_state = (self.device_state
                     if self.config.match.device_residency else None)
        if self.columnar is not None and not self._backfill_active:
            queue = rank_pool_columnar(
                self._pool_store(pool), self.columnar, pool,
                device=self.device,
                capacity_limits=((max_mem, max_cpus, max_gpus)
                                 if limits_active else None),
                device_state=dru_state)
        else:
            # predicted-duration backfill routes through the full encoder
            # (the columnar fast path carries no duration column)
            filt = (offensive_job_filter(max_mem, max_cpus, max_gpus)
                    if limits_active else None)
            queue = rank_pool(
                self._pool_store(pool), pool, device=self.device,
                offensive_job_filter=filt,
                predictor=(self.predictor if self._backfill_active
                           else None),
                backfill_weight=self.config.backfill_weight,
                backfill_norm_ms=self.config.backfill_norm_ms,
                device_state=dru_state)
        for uuid in queue.quarantined:
            self.placement_failures[uuid] = (
                "The job's resource demands exceed every host in the pool."
            )
        self.pool_queues[pool.name] = queue
        global_registry.gauge(
            "rank.queue_len", "ranked queue length per pool").set(
            len(queue.jobs), {"pool": pool.name})
        # fairness trajectory sample: the rank cycle is the one moment
        # the per-user fair-share picture (queue DRU + running usage) is
        # coherent in one place
        self.fairness.observe_rank(pool.name, queue,
                                   self._pool_store(pool))
        # stash the duration so the NEXT match cycle's record can claim
        # its rank phase (the simulator ranks as a separate step)
        self._last_rank_s[pool.name] = time.perf_counter() - t_rank
        if self.telemetry is not None and queue.solve_shape is not None:
            # compile accounting for the DRU solve's padded task bucket;
            # no seconds: the rank wall is not device solve time
            self.telemetry.record_solve("rank", queue.solve_shape, "xla")
        return queue

    def _begin_cycle(self, pool_name: str):
        if self.recorder is None:
            return NULL_CYCLE
        flight = self.recorder.begin(pool_name, self.store.clock())
        # the pool's capacity at cycle start + the capacity plan the cycle
        # ran under, so elastic deltas correlate with match outcomes
        # record to record
        flight.record.pool_capacity = self._pool_capacity_snapshot(pool_name)
        if self.elastic is not None:
            flight.record.elastic_plan = self.elastic.recorder.last_plan_id()
        return flight

    def _pool_capacity_snapshot(self, pool_name: str) -> dict:
        """Host count + total/spare capacity the pool holds right now (one
        offer scan per recorded cycle: the post-match spare cache cannot
        give the capacity AT CYCLE START; gpu totals are not carried by
        offers, so only spare is reported there)."""
        hosts = 0
        mem = cpus = 0.0
        spare = {"mem": 0.0, "cpus": 0.0, "gpus": 0.0}
        for _cluster, offer in scan_pool_offers(self.clusters, pool_name):
            hosts += 1
            mem += offer.total_mem or offer.mem
            cpus += offer.total_cpus or offer.cpus
            spare["mem"] += max(offer.mem, 0.0)
            spare["cpus"] += max(offer.cpus, 0.0)
            spare["gpus"] += max(offer.gpus, 0.0)
        return {"hosts": hosts, "mem": mem, "cpus": cpus,
                "spare_mem": spare["mem"], "spare_cpus": spare["cpus"],
                "spare_gpus": spare["gpus"]}

    def _commit_cycle(self, flight) -> None:
        if self.recorder is not None and flight.record is not None:
            self.recorder.commit(flight)

    def _credit_rank_and_quarantine(self, flight, pool_name: str,
                                    queue) -> None:
        """Cycle-record prologue: claim the most recent rank cycle's
        duration, and record the jobs the rank cycle's offensive-job
        filter quarantined (the matcher never sees them)."""
        rank_s = self._last_rank_s.pop(pool_name, None)
        if rank_s is not None:
            flight.add_phase("rank", rank_s)
        for uuid in queue.quarantined:
            flight.note_skip(uuid, EXCEEDS_POOL_CAPACITY)

    def match_cycle(self, pool: Pool) -> MatchOutcome:
        flight = self._begin_cycle(pool.name)
        queue = self.pool_queues.get(pool.name)
        if queue is None:
            queue = self.rank_cycle(pool)
        self._credit_rank_and_quarantine(flight, pool.name, queue)
        state = self.pool_match_state.setdefault(
            pool.name,
            PoolMatchState(
                num_considerable=self.config.match.max_jobs_considered),
        )
        self.admission.clamp(pool.name, state,
                             self.config.match.max_jobs_considered)
        # the cycle's data-plane scope covers the speculation commit too:
        # a hit's only transfer is the speculative assignment's fetch (its
        # tensor build ran during the PREVIOUS cycle's drain, scope-less),
        # so hit cycles report near-zero H2D; match_pool re-enters the
        # scope around each of its sections
        walls: dict[str, float] = {}
        with data_plane.activate(flight.dp):
            outcome = self._try_speculative_cycle(pool, queue, state,
                                                  flight, walls)
        if outcome is None:
            with data_plane.activate(flight.dp):
                outcome = match_pool(
                    self._pool_store(pool),
                    pool,
                    queue,
                    self.clusters,
                    self.config.match,
                    state,
                    device=self.device,
                    make_task_id=self._make_task_id,
                    launch_filter=self._make_launch_filter(),
                    record_placement_failure=self._record_placement_failure,
                    host_reservations=self.host_reservations,
                    host_attrs=self.host_attr_cache,
                    flight=flight,
                    telemetry=self.telemetry,
                    encode_cache=self.encode_cache,
                    predictor=self.predictor,
                    device_state=self.device_state,
                )
        outcome.phase_wall_s.update(walls)
        self._after_match(pool, outcome, flight)
        # speculate cycle N+1 while this cycle's work drains (launches in
        # the serial path are synchronous, so every event this cycle
        # produced has already landed — the guard token opens clean)
        self._dispatch_speculation([pool])
        return outcome

    # ------------------------------------------------ speculative cycles

    def _speculation_commit(self, pool, queue, state, flight, walls):
        """One pool's speculation commit attempt (the commit rule of
        scheduler/prediction.py), recorded on the cycle record, its wall
        in `walls["speculation_commit"]`.  On a hit the cycle-record
        bookkeeping a fresh prepare would have done (counts, rank context,
        not-considered index, solve identity, quality sample) runs here.
        Returns the CommitResult, or None when no speculator is
        attached."""
        if self.speculator is None:
            return None
        t0 = time.perf_counter()
        with flight.phase("speculation_commit"):
            result = self.speculator.try_commit(
                pool, queue, state, self.config.match,
                launch_filter=self._make_launch_filter())
        walls["speculation_commit"] = time.perf_counter() - t0
        flight.note_speculation(result.status, result.reason)
        if result.ok:
            prepared = result.prepared
            record_considered(flight, queue, prepared.considerable,
                              len(prepared.cluster_offers))
            # the backend label marks the cycle as speculative-served; no
            # telemetry latency sample — the solve's wall spanned the
            # previous cycle's drain, not this cycle's critical path
            flight.note_solve(
                shape_signature(problem_shape(prepared.problem)),
                f"spec-{solve_backend(self.config.match)}", False)
            if self.telemetry is not None:
                self.telemetry.quality.observe_cycle(
                    prepared, result.assignment, pool.name)
        return result

    def _try_speculative_cycle(self, pool, queue, state, flight, walls):
        """Serve the cycle from a committed speculation; None = solve
        fresh (nothing in flight, or the speculation was dropped)."""
        result = self._speculation_commit(pool, queue, state, flight,
                                          walls)
        if result is None or not result.ok:
            return None
        t0 = time.perf_counter()
        with flight.phase("launch"):
            outcome = finalize_pool_match(
                self.store, result.prepared, result.assignment,
                self.config.match, state, self.clusters,
                make_task_id=self._make_task_id,
                record_placement_failure=self._record_placement_failure,
                flight=flight)
        walls["launch"] = time.perf_counter() - t0
        return outcome

    def _dispatch_speculation(self, pools) -> None:
        """End-of-cycle speculative dispatch (prediction.py): predict the
        completions the next cycle will see, pre-encode its problem and
        queue its solve on the card, which works through the drain and
        the inter-cycle idle.  Runs AFTER the cycle's launches and their
        store events have landed, or the guard would mark the fresh
        speculation stale against our own events."""
        if self.speculator is None:
            return
        for pool in pools:
            state = self.pool_match_state.get(pool.name)
            if state is None:
                continue
            self.speculator.dispatch(
                pool, self.config.match, state,
                launch_filter=self._make_launch_filter(),
                host_reservations=self.host_reservations,
                host_attrs=self.host_attr_cache,
                offensive_job_filter=self._offensive_filter(pool),
                predictor_for_rank=(self.predictor
                                    if self._backfill_active else None),
                backfill_weight=self.config.backfill_weight,
                backfill_norm_ms=self.config.backfill_norm_ms)

    def match_cycle_all_pools(self) -> dict[str, MatchOutcome]:
        """Pool-batched multi-pool match: every scheduling pool's flat
        problem solved in one device call, a pool at or over the
        hierarchical threshold through the two-level path alone
        (matcher.match_pools_batched).  The reference's mesh argument has
        no counterpart on one card."""
        pools, flights = self._begin_multi_pool_cycle()
        outcomes = match_pools_batched(
            self.store, pools, self.pool_queues, self.clusters,
            self.config.match, self.pool_match_state,
            device=self.device,
            make_task_id=self._make_task_id,
            launch_filter=self._make_launch_filter(),
            record_placement_failure=self._record_placement_failure,
            host_reservations=self.host_reservations,
            host_attrs=self.host_attr_cache,
            flights=flights,
            telemetry=self.telemetry,
            encode_cache=self.encode_cache,
            predictor=self.predictor,
            device_state=self.device_state,
        )
        self._finish_multi_pool_cycle(pools, outcomes, flights)
        return outcomes

    def match_cycle_pipelined(self) -> dict[str, MatchOutcome]:
        """Pipelined multi-pool match pass (scheduler/pipeline.py): pool
        k's device solve overlaps pool k+1's host encode and pool k-1's
        finalize/launch; transactions still commit in pool order and
        launches fan out on the per-cluster executors.  With a
        speculator, each pool's in-flight speculation is committed or
        dropped up front (a committed pool enters the pass pre-solved),
        and the next pass's solves are dispatched once the pass's
        launches have drained."""
        pools, flights = self._begin_multi_pool_cycle()
        speculative = {}
        walls: dict[str, dict[str, float]] = {}
        if self.speculator is not None:
            for pool in pools:
                # per-pool scope: the commit's assignment fetch (a hit's
                # only transfer) attributes to its own cycle record
                walls[pool.name] = {}
                with data_plane.activate(flights[pool.name].dp):
                    result = self._speculation_commit(
                        pool, self.pool_queues[pool.name],
                        self.pool_match_state[pool.name],
                        flights[pool.name], walls[pool.name])
                if result.ok:
                    speculative[pool.name] = result
        outcomes = match_pools_pipelined(
            self.store, pools, self.pool_queues, self.clusters,
            self.config.match, self.pool_match_state,
            device=self.device,
            make_task_id=self._make_task_id,
            launch_filter=self._make_launch_filter(),
            record_placement_failure=self._record_placement_failure,
            host_reservations=self.host_reservations,
            host_attrs=self.host_attr_cache,
            flights=flights,
            telemetry=self.telemetry,
            encode_cache=self.encode_cache,
            recorder=self.recorder,
            params=PipelineParams(depth=self.config.pipeline_depth,
                                  async_launch=self.config.async_launch),
            predictor=self.predictor,
            speculative=speculative,
            device_state=self.device_state,
        )
        for name, pool_walls in walls.items():
            outcomes[name].phase_wall_s.update(pool_walls)
        self._finish_multi_pool_cycle(pools, outcomes, flights)
        # the pass drained its async launches, so every launch event has
        # landed: speculate the next pass's solves into the inter-cycle
        # idle
        self._dispatch_speculation(pools)
        return outcomes

    def drain_launches(self, timeout: Optional[float] = None) -> bool:
        """Wait for every cluster's in-flight async launch batches."""
        return not wait_all_launches(self.clusters, timeout=timeout)

    def _begin_multi_pool_cycle(self):
        """Shared prologue of the batched and pipelined multi-pool
        passes: flight builders, rank-if-missing, rank/quarantine
        credit, per-pool match state and its admission clamp."""
        pools = [p for p in self.store.pools.values() if p.schedules_jobs]
        flights = {pool.name: self._begin_cycle(pool.name) for pool in pools}
        for pool in pools:
            if pool.name not in self.pool_queues:
                self.rank_cycle(pool)
            self._credit_rank_and_quarantine(
                flights[pool.name], pool.name, self.pool_queues[pool.name])
            state = self.pool_match_state.setdefault(
                pool.name,
                PoolMatchState(
                    num_considerable=self.config.match.max_jobs_considered),
            )
            self.admission.clamp(pool.name, state,
                                 self.config.match.max_jobs_considered)
        return pools, flights

    def _finish_multi_pool_cycle(self, pools, outcomes, flights) -> None:
        """Shared epilogue of the batched and pipelined multi-pool
        passes: what `match_cycle` does after its match, pool by pool."""
        for pool in pools:
            self._after_match(pool, outcomes[pool.name], flights[pool.name])

    def _after_match(self, pool: Pool, outcome: MatchOutcome,
                     flight) -> None:
        """A pool's match epilogue on every path: per-user rate-limiter
        spend-through, host-reservation release, the queue's upkeep, the
        spare cache, the record commit."""
        # charge launches against the per-user rate limiter (without the
        # spend-through the bucket refills to full burst every cycle and
        # the configured sustained rate is never enforced)
        if self.launch_rate_limiter is not None:
            for job, _ in outcome.matched:
                self.launch_rate_limiter.spend((job.user, job.pool))
        matched_uuids = {j.uuid for j, _ in outcome.matched}
        # launched jobs release their host reservations; a placed gang
        # releases its group-wide gang:<group> reservations
        matched_tags = matched_uuids | {
            gang_reservation_tag(j.group_uuid)
            for j, _ in outcome.matched if j.group_uuid}
        if self.host_reservations:
            self.host_reservations = {
                host: tag for host, tag in self.host_reservations.items()
                if tag not in matched_tags
            }
        queue = self.pool_queues[pool.name]
        queue.jobs = [j for j in queue.jobs if j.uuid not in matched_uuids]
        # cache spare resources for the rebalancer (view-incubating-offers,
        # scheduler.clj:1537): offers minus what this cycle just placed
        self._cache_spare(pool)
        global_registry.counter(
            "match.matched", "jobs matched to hosts per pool").inc(
            len(outcome.matched), {"pool": pool.name})
        global_registry.gauge(
            "match.offers", "offers seen by the last match cycle").set(
            outcome.offers_total, {"pool": pool.name})
        if flight.record is not None:
            flight.record.head_matched = outcome.head_matched
        self._commit_cycle(flight)

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

    def _rebalancer_params(self) -> RebalancerParams:
        """Config-file defaults overridden by runtime-mutable dynamic
        config (reference: Datomic-resident `:rebalancer/config`,
        rebalancer.clj:535-557 — tuning preemption must not need a
        restart): the store's `dynamic_config["rebalancer"]`."""
        overrides = self.store.dynamic_config.get("rebalancer")
        base = self.config.rebalancer
        if not isinstance(overrides, dict):
            return base
        return RebalancerParams(
            safe_dru_threshold=float(overrides.get(
                "safe_dru_threshold", base.safe_dru_threshold)),
            min_dru_diff=float(overrides.get(
                "min_dru_diff", base.min_dru_diff)),
            max_preemption=int(overrides.get(
                "max_preemption", base.max_preemption)),
            fast_cycle=bool(overrides.get(
                "fast_cycle", base.fast_cycle)),
            gang_enabled=bool(overrides.get(
                "gang_enabled", base.gang_enabled)),
            gang_max_admissions=int(overrides.get(
                "gang_max_admissions", base.gang_max_admissions)),
            gang_drain_max_wait_ms=float(overrides.get(
                "gang_drain_max_wait_ms", base.gang_drain_max_wait_ms)),
            gang_drain_wasted_factor=float(overrides.get(
                "gang_drain_wasted_factor", base.gang_drain_wasted_factor)),
            resident=bool(overrides.get("resident", base.resident)),
        )

    def _rebalance_mirror(self, pool: Pool) -> ResidentRows:
        """Per-pool ResidentRows mirror for the rebalancer's victim
        tensors — owned HERE so it outlives every cycle (warm reuse is the
        point; a cycle-scoped mirror would always rebuild cold)."""
        mirror = self._rebalance_mirrors.get(pool.name)
        if mirror is None:
            mirror = ResidentRows(
                f"rebalance:{pool.name}",
                observatory=(self.telemetry.observatory
                             if self.telemetry is not None else None),
                family=data_plane.FAM_REBALANCE, device=self.device)
            self._rebalance_mirrors[pool.name] = mirror
        return mirror

    def rebalance_cycle(self, pool: Pool) -> list[Decision]:
        """One pool's preemption pass (rebalancer.clj:434-533): the
        victim search on the device, the preemption ledger, the kills, a
        host reservation for each decision that took several victims, then
        gang admission."""
        queue = self.pool_queues.get(pool.name) or self.rank_cycle(pool)
        # the timer starts AFTER the queue lookup: a rank triggered here is
        # credited to the next match cycle's rank phase
        t0 = time.perf_counter()
        params = self._rebalancer_params()
        spare = self.last_unmatched_offers.get(pool.name, {})
        decisions = rebalance_pool(
            self.store, pool, queue.jobs, spare, params,
            host_info=self.last_host_info.get(pool.name),
            device=self.device,
            telemetry=self.telemetry,
            # reclaim-before-preemption: loaned-out capacity comes home
            # (non-disruptively) before any victim search considers a kill
            reclaimer=(self.elastic.reclaim_for
                       if self.elastic is not None else None),
            resident=(self._rebalance_mirror(pool)
                      if params.resident else None),
        )
        # fairness ledger: per-victim wasted-work seconds must be read
        # BEFORE _transact_preemption flips the instances terminal (the
        # runtime destroyed is clock() - start at the kill)
        now_ms = self.store.clock()
        block_of = self._host_block_map(pool, spare)
        ledger_entries = []
        for d in decisions:
            if not d.task_ids:
                continue
            victims = []
            for v in d.victims:
                inst = self.store.instances.get(v["task_id"])
                wasted_s = 0.0
                # start_time_ms is always clock-stamped at create; 0 is
                # a REAL start under the simulator's virtual clock
                if inst is not None and not inst.status.terminal:
                    wasted_s = max(
                        0.0, (now_ms - inst.start_time_ms) / 1000.0)
                victims.append(dict(v, wasted_s=round(wasted_s, 3)))
            ledger_entries.append({
                "t_ms": now_ms,
                "preemptor_job": d.job.uuid,
                "preemptor_user": d.job.user,
                "hostname": d.hostname,
                # topology block of the freed host: the observatory's
                # block-aware fragmentation groups freed capacity by block
                "block": block_of.get(d.hostname, -1),
                "min_preempted_dru": d.min_preempted_dru,
                "victims": victims,
                "wasted_s": round(sum(v["wasted_s"] for v in victims), 3),
                "freed": {"mem": sum(v["mem"] for v in victims),
                          "cpus": sum(v["cpus"] for v in victims),
                          "gpus": sum(v["gpus"] for v in victims)},
            })
        fairness_rollup = self.fairness.record_decisions(
            pool.name, ledger_entries)
        if self.recorder is not None:
            by_job = {e["preemptor_job"]: e for e in ledger_entries}
            self.recorder.annotate_preemptions(
                pool.name,
                [PreemptionRecord(
                    job_uuid=d.job.uuid, hostname=d.hostname,
                    task_ids=list(d.task_ids),
                    min_preempted_dru=d.min_preempted_dru,
                    preemptor_user=d.job.user,
                    victims=by_job.get(d.job.uuid, {}).get("victims", []),
                    wasted_s=by_job.get(d.job.uuid, {}).get("wasted_s", 0.0))
                 for d in decisions if d.task_ids],
                time.perf_counter() - t0,
                fairness=fairness_rollup if ledger_entries else None,
            )
        for decision in decisions:
            self._transact_preemption(decision)
            if len(decision.task_ids) > 1:
                # multi-task preemptions reserve the host for the job they
                # made room for, so the next match sends it there
                self.host_reservations[decision.hostname] = decision.job.uuid
        n_preempted = sum(len(d.task_ids) for d in decisions)
        self.metrics[f"rebalance.{pool.name}.preempted"] = n_preempted
        global_registry.counter(
            "rebalance.preempted",
            "tasks preempted by the rebalancer per pool").inc(
            n_preempted, {"pool": pool.name})
        self._gang_admission_cycle(pool, queue, spare)
        return decisions

    def _host_block_map(self, pool: Pool, spare: dict) -> dict[str, int]:
        """hostname -> topology block index (sorted hosts chunked by the
        match config's block width), the fairness ledger's block stamp."""
        hostnames = sorted(
            set(spare)
            | {i.hostname for i in self.store.running_instances(pool.name)
               if i.hostname})
        npb = topology_block_width(self.config.match, len(hostnames))
        return {h: i // npb for i, h in enumerate(hostnames)}

    def _gang_admission_cycle(self, pool: Pool, queue: RankedQueue,
                              spare: dict) -> list[GangAdmission]:
        """Topology-aware gang admission (scheduler/gang.py, reference
        core.py:1059-1151): whole-gang drain-vs-kill decisions riding the
        rebalance cycle.  Preempt-less admissions only reserve hosts (the
        block drains into the reservation); preempt admissions transact
        contiguous in-block victim sets like any rebalancer kill."""
        params = self._rebalancer_params()
        if not (params.gang_enabled and self.config.match.gang_enabled):
            return []
        waiting_groups = {
            gang_reservation_tag(j.group_uuid) for j in queue.jobs
            if j.gang_size >= 2 and j.group_uuid}
        # stale gang reservations (gang canceled / placed via another
        # pool) must not squat on hosts
        self.host_reservations = {
            host: tag for host, tag in self.host_reservations.items()
            if not tag.startswith(GANG_RESERVATION_PREFIX)
            or tag in waiting_groups}
        if not waiting_groups:
            return []
        admissions = plan_gang_admissions(
            self.store, pool, queue.jobs, spare,
            nodes_per_block=topology_block_width(
                self.config.match, max(len(spare), 1)),
            predictor=self.predictor,
            params=params,
            now_ms=self.store.clock(),
            reserved=set(self.host_reservations),
        )
        now_ms = self.store.clock()
        gang_entries = []
        for adm in admissions:
            tag = gang_reservation_tag(adm.group_uuid)
            for host in adm.hosts:
                self.host_reservations[host] = tag
            victims = []
            for task_id in adm.victims:
                inst = self.store.instances.get(task_id)
                if inst is None or inst.status.terminal:
                    continue
                job = self.store.jobs.get(inst.job_uuid)
                victims.append({
                    "task_id": task_id,
                    "user": job.user if job is not None else "",
                    "dru": 0.0,
                    "mem": job.resources.mem if job is not None else 0.0,
                    "cpus": job.resources.cpus if job is not None else 0.0,
                    "gpus": job.resources.gpus if job is not None else 0.0,
                    "wasted_s": round(max(
                        0.0, (now_ms - inst.start_time_ms) / 1000.0), 3),
                })
                self.store.update_instance_state(
                    task_id, InstanceStatus.FAILED,
                    "preempted-by-rebalancer")
                cluster = self.cluster_by_name(inst.compute_cluster)
                if cluster is not None:
                    cluster.safe_kill_task(task_id)
            if victims:
                # gang kills join the fairness ledger like any rebalancer
                # decision, block-stamped
                gang_entries.append({
                    "t_ms": now_ms,
                    "preemptor_job": adm.leader_uuid,
                    "preemptor_user": "",
                    "hostname": ",".join(adm.hosts),
                    "block": adm.block,
                    "min_preempted_dru": 0.0,
                    "victims": victims,
                    "wasted_s": round(
                        sum(v["wasted_s"] for v in victims), 3),
                    "freed": {
                        "mem": sum(v["mem"] for v in victims),
                        "cpus": sum(v["cpus"] for v in victims),
                        "gpus": sum(v["gpus"] for v in victims)},
                })
            global_registry.counter(
                "gang.admissions",
                "gang admission decisions by the rebalance cycle per "
                "pool and mode (drain = preempt-less)").inc(
                1, {"pool": pool.name, "mode": adm.mode})
        if gang_entries:
            self.fairness.record_decisions(pool.name, gang_entries)
        self.metrics[f"rebalance.{pool.name}.gang_admissions"] = len(
            admissions)
        self.last_gang_admissions = [a.to_json() for a in admissions]
        return admissions

    def elastic_cycle(self):
        """One capacity-plane planning interval (cook_tpu_torch/elastic/):
        rank queues feed the demand tensors, the plan commits durable
        pool-capacity deltas and converges cluster capacity.  Driven by
        the simulator (the reference's service drives it from a trigger
        loop); returns the PlanRecord (None when elastic is disabled or
        single-pool)."""
        if self.elastic is None:
            return None
        for pool in [p for p in self.store.pools.values()
                     if p.schedules_jobs]:
            if pool.name not in self.pool_queues:
                self.rank_cycle(pool)
        record = self.elastic.plan_cycle(self.pool_queues)
        if record is not None:
            self.metrics["elastic.last_plan"] = record.plan_id
        return record

    def _transact_preemption(self, decision: Decision) -> None:
        """transact-preemption! + safe-kill-task (rebalancer.clj:482-533)."""
        for task_id in decision.task_ids:
            inst = self.store.instances.get(task_id)
            if inst is None or inst.status.terminal:
                continue
            self.store.update_instance_state(
                task_id, InstanceStatus.FAILED, "preempted-by-rebalancer"
            )
            cluster = self.cluster_by_name(inst.compute_cluster)
            if cluster is not None:
                cluster.safe_kill_task(task_id)

    def _record_placement_failure(self, job: Job, reason: str) -> None:
        self.placement_failures[job.uuid] = reason

    def _make_launch_filter(self):
        """Considerable-job filters: per-user launch rate limit
        (pending-jobs->considerable-jobs, scheduler.clj:729) + the
        JobLaunchFilter plugins with TTL cache (plugins/launch.clj).
        Returns a per-cycle closure, or None when neither is on: the rate
        budget is snapshotted at cycle start and debited as jobs are
        selected, so one cycle can't select more launches than the bucket
        holds."""
        if self.launch_rate_limiter is None and not self.plugins.launch_filters:
            return None
        budget: dict = {}

        def launch_filter(job: Job) -> bool:
            if self.launch_rate_limiter is not None:
                key = (job.user, job.pool)
                remaining = budget.get(key)
                if remaining is None:
                    remaining = self.launch_rate_limiter.tokens_available(
                        key)
                if remaining < 1.0:
                    budget[key] = remaining
                    return False
                budget[key] = remaining - 1.0
            if not self.plugins.launch_filters:
                return True
            return self.plugins.check_launch(
                job, self.store.clock(), self._launch_filter_cache
            )

        return launch_filter

    # ------------------------------------------------------------ monitors

    def kill_lingering_tasks(self, now_ms: int) -> list[str]:
        """Max-runtime enforcement (lingering-task-killer,
        scheduler.clj:1941-1974)."""
        killed = []
        for pool_name in list(self.store.pools):
            for inst in self.store.running_instances(pool_name):
                job = self.store.jobs[inst.job_uuid]
                if job.max_runtime_ms and inst.start_time_ms + job.max_runtime_ms <= now_ms:
                    self.store.update_instance_state(
                        inst.task_id, InstanceStatus.FAILED,
                        "max-runtime-exceeded",
                    )
                    cluster = self.cluster_by_name(inst.compute_cluster)
                    if cluster is not None:
                        cluster.safe_kill_task(inst.task_id)
                    killed.append(inst.task_id)
        return killed

    def kill_stragglers(self, now_ms: int) -> list[str]:
        """Group straggler handling (straggler-handler, scheduler.clj:1976;
        docs/groups.md quantile-deviation): if a group's running task has
        run longer than `multiplier` x the `quantile` runtime of its
        completed siblings, kill it mea-culpa."""
        killed = []
        for group in self.store.groups.values():
            sh = group.straggler_handling
            if sh.type != "quantile-deviation":
                continue
            completed_ms = []
            running: list = []
            for member in group.job_uuids:
                for inst in self.store.job_instances(member):
                    if inst.status == InstanceStatus.SUCCESS:
                        completed_ms.append(inst.end_time_ms - inst.start_time_ms)
                    elif inst.status == InstanceStatus.RUNNING:
                        running.append(inst)
            if len(completed_ms) < 2:
                continue
            quantiles = statistics.quantiles(completed_ms, n=100)
            threshold = quantiles[int(sh.quantile * 100) - 1] * sh.multiplier
            for inst in running:
                if now_ms - inst.start_time_ms > threshold:
                    self.store.update_instance_state(
                        inst.task_id, InstanceStatus.FAILED, "straggler"
                    )
                    cluster = self.cluster_by_name(inst.compute_cluster)
                    if cluster is not None:
                        cluster.safe_kill_task(inst.task_id)
                    killed.append(inst.task_id)
        return killed

    def kill_cancelled_tasks(self) -> list[str]:
        """cancelled-task-killer (scheduler.clj:2000)."""
        killed = []
        for inst in list(self.store.instances.values()):
            if inst.cancelled and not inst.status.terminal:
                self.store.update_instance_state(
                    inst.task_id, InstanceStatus.FAILED, "killed-by-user"
                )
                cluster = self.cluster_by_name(inst.compute_cluster)
                if cluster is not None:
                    cluster.safe_kill_task(inst.task_id)
                killed.append(inst.task_id)
        return killed

    def reconcile(self) -> list[str]:
        """Resync store vs backends (reconcile-tasks, scheduler.clj:1828):
        store-live tasks unknown to their backend are failed mea-culpa."""
        fixed = []
        backend_known: set[str] = set()
        for cluster in self.clusters:
            running = getattr(cluster, "running", None)
            if running is not None:
                backend_known.update(running.keys())
        for inst in list(self.store.instances.values()):
            if inst.status.terminal:
                continue
            if inst.task_id not in backend_known:
                self.store.update_instance_state(
                    inst.task_id, InstanceStatus.FAILED, "task-unknown"
                )
                fixed.append(inst.task_id)
        return fixed
