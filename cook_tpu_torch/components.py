"""Process wiring: config -> store/clusters/scheduler/REST/trigger loops.

Port of `cook_tpu/components.py` (reference: cook.components, -main,
components.clj:257-365, the trigger channels `make-trigger-chans`,
mesos.clj:89-110, and the leadership wiring, mesos.clj:153-328): the REST
server runs on every node; the scheduling loops run only on the leader;
losing leadership fail-fast exits.

Ported: `build_process` (journal and snapshot recovery through
`models/persistence`, one `txn` commit pipeline for REST mutations and
the elastic plane, the elastic parameters, the replication and
replica-read knobs, the metrics history, the incident directory; with
`shards > 1` the sharded store of `shard/`: a single-journal data_dir
migrated once, `recover_sharded`, one journal segment per shard and the
sharded commit pipeline), `start_leader_duties` (the elector the config
names — the lease service's `HttpLeaseElector`, a `FileLeaseElector`, or
the in-memory one; while standing by, a `control/replication.
JournalFollower` — one per shard, `shard/replica.ShardedJournalFollower`,
on a sharded store — tailing the leader into this node's store and
journal; the promotion invariants; the rank, match, rebalance, elastic,
snapshot, mock-advance, health-watch, heartbeat, monitor, progress,
sandbox, lingering, straggler, cancelled and optimizer loops) and
`shutdown`, which also joins the loops' threads.  The scheduler runs on
the device that `Settings.platform` names: the card by default, where
`build_process` raises through `device.resolve` when there is none.

A standby's scheduler is passive: replicated events reach its columnar
index and caches through the store's watchers on the follower's thread,
all host-side bookkeeping — none touches the card — and the first match
cycle after promotion runs on an index checked against the store.

The leader also runs the fleet observatory (`obs/fleet.py`, every
`fleet_poll_s`): it polls `Settings.peers` and every standby that acked
the replication feed with its URL, and serves the merged verdict at
`GET /debug/fleet`.

The Kubernetes backend (`cluster/k8s.py`, `cluster/k8s_http.py`) is a
cluster kind like the mock: `k8s` over the in-memory `FakeKubeApi`,
`k8s-http` over a real apiserver.  Its controller takes up its duties
with leadership (`start_cluster_backend`): the expected state rebuilt
from the store's live instances first, then the apiserver watch, then a
30 s anti-entropy scan loop.  A standby never watches, so it never acts
on the leader's pods.
"""
from __future__ import annotations

import itertools
import logging
import os
import threading
import time
import uuid as uuid_mod
from dataclasses import dataclass, field
from typing import Callable, Optional

from cook_tpu_torch.cluster.base import ComputeCluster
from cook_tpu_torch.cluster.mock import MockCluster, MockHost
from cook_tpu_torch.control.leader import (
    FileLeaseElector,
    HttpLeaseElector,
    InMemoryElector,
    LeaderSelector,
)
from cook_tpu_torch.models.entities import DruMode, Pool
from cook_tpu_torch.models.store import JobStore
from cook_tpu_torch.rest.api import ApiConfig, CookApi
from cook_tpu_torch.rest.server import ServerThread
from cook_tpu_torch.scheduler.core import Scheduler, SchedulerConfig
from cook_tpu_torch.utils.config import Settings, device_for_platform
from cook_tpu_torch.utils.logging import log_info
from cook_tpu_torch.utils.tracing import span

log = logging.getLogger(__name__)


def wall_clock_ms() -> int:
    return int(time.time() * 1000)


CLUSTER_FACTORIES: dict[str, Callable[[dict, Callable[[], int]], ComputeCluster]] = {}


def register_cluster_factory(kind: str):
    """Factories also attach the per-cluster launch rate limiter
    (launch-rate-limiter, rate_limit.clj:44) from the cluster config:
    {"launch_rate_per_minute": N, "launch_burst": M} — applies to every
    cluster kind, static or REST-created."""

    def deco(fn):
        def wrapped(conf: dict, clock) -> ComputeCluster:
            cluster = fn(conf, clock)
            rate = float(conf.get("launch_rate_per_minute", 0) or 0)
            if rate > 0:
                from cook_tpu_torch.scheduler.ratelimit import (
                    TokenBucketRateLimiter,
                )

                cluster.launch_rate_limiter = TokenBucketRateLimiter(
                    tokens_replenished_per_minute=rate,
                    bucket_size=float(conf.get("launch_burst", rate)),
                    clock=clock,
                )
            return cluster

        CLUSTER_FACTORIES[kind] = wrapped
        return fn
    return deco


@register_cluster_factory("mock")
def _mock_factory(conf: dict, clock) -> ComputeCluster:
    hosts = [
        MockHost(
            node_id=h["node_id"],
            hostname=h.get("hostname", h["node_id"]),
            mem=float(h["mem"]),
            cpus=float(h["cpus"]),
            gpus=float(h.get("gpus", 0.0)),
            disk=float(h.get("disk", 0.0)),
            pool=h.get("pool", "default"),
            attributes=tuple(sorted(h.get("attributes", {}).items())),
            ports=tuple((int(b), int(e)) for b, e in h.get("ports", [])),
        )
        for h in conf.get("hosts", [])
    ]
    return MockCluster(conf["name"], hosts, clock,
                       default_runtime_ms=int(
                           conf.get("default_runtime_ms", 60_000)))


@register_cluster_factory("k8s")
def _k8s_factory(conf: dict, clock) -> ComputeCluster:
    from cook_tpu_torch.cluster.k8s import FakeKubeApi, KubeCluster

    api = conf.get("api") or FakeKubeApi()
    return KubeCluster(conf["name"], api, clock,
                       synthetic_pod_limits=conf.get("synthetic_pods", {}))


@register_cluster_factory("k8s-http")
def _k8s_http_factory(conf: dict, clock) -> ComputeCluster:
    """A real apiserver-backed cluster (kubernetes/api.clj analog):

        {"kind": "k8s-http", "name": "prod", "url": "https://apiserver",
         "namespace": "cook", "token_file": "/var/run/.../token",
         "ca_file": "...", "file_server_port": 8000}

    Its pod watch starts with leadership (`start_cluster_backend`), not
    here: the reference starts it here, so that on every node, a standby
    or a restarted leader included, the watch's first re-list reaches a
    controller that expects nothing and deletes every live pod as an
    orphan."""
    from cook_tpu_torch.cluster.k8s import KubeCluster
    from cook_tpu_torch.cluster.k8s_http import HttpKubeApi

    api = HttpKubeApi(
        conf["url"],
        namespace=conf.get("namespace", "default"),
        token_file=conf.get("token_file"),
        ca_file=conf.get("ca_file"),
        insecure_skip_verify=bool(conf.get("insecure_skip_verify", False)),
        default_image=conf.get("default_image", "busybox:stable"),
        file_server_port=int(conf.get("file_server_port", 0)),
        file_server_image=conf.get("file_server_image", ""),
        watch_timeout_s=float(conf.get("watch_timeout_s", 300.0)),
        checkpoint_tools_image=conf.get("checkpoint_tools_image", ""),
    )
    return KubeCluster(conf["name"], api, clock,
                       synthetic_pod_limits=conf.get("synthetic_pods", {}))


def start_cluster_backend(cluster, store) -> None:
    """A k8s cluster's controller takes up its duties on the leader
    (determine-expected-state-on-startup, compute_cluster.clj:269): its
    expected state from the store's live instances on it, then its
    apiserver watch (initialize-pod-watch).  In that order, so that the
    watch's first re-list finds each live pod expected.  A no-op for
    other kinds."""
    determine = getattr(cluster, "determine_expected_state_on_startup",
                        None)
    if determine is None:
        return
    determine({i.task_id for i in store.instances.values()
               if not i.status.terminal
               and i.compute_cluster == cluster.name})
    start = getattr(cluster.api, "start", None)
    if start is not None:
        start()


def _scannable(clusters) -> list:
    return [c for c in clusters if hasattr(c, "scan_all")]


class TriggerLoop:
    """A periodic trigger thread (chime/trigger-chan analog).  Also
    manually fireable for tests/simulator."""

    def __init__(self, name: str, interval_s: float, fn: Callable[[], None]):
        self.name = name
        self.interval_s = interval_s
        self.fn = fn
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "TriggerLoop":
        def loop():
            while not self._stop.wait(self.interval_s):
                try:
                    self.fn()
                except Exception:  # noqa: BLE001 — loops must survive
                    log.exception("trigger %s failed", self.name)

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name=f"trigger-{self.name}")
        self._thread.start()
        return self

    def fire(self) -> None:
        self.fn()

    def stop(self) -> None:
        self._stop.set()

    def join(self, timeout: Optional[float] = None) -> None:
        """Wait for a stopped loop's thread to leave its current run."""
        if self._thread is not None:
            self._thread.join(timeout)


@dataclass
class CookProcess:
    """Everything one scheduler process runs."""

    settings: Settings
    store: JobStore = None
    clusters: list = field(default_factory=list)
    scheduler: Scheduler = None
    api: CookApi = None
    server: ServerThread = None
    selector: LeaderSelector = None
    loops: list = field(default_factory=list)
    member_id: str = ""
    progress_aggregator: object = None
    heartbeats: object = None
    sandbox_publisher: object = None
    journal: object = None
    # sharded layout: one JournalWriter per shard segment (journal stays
    # None); unsharded: [journal]
    journals: list = field(default_factory=list)
    follower: object = None  # standby-side journal replication
    # durable multi-resolution metrics history (obs/tsdb.py)
    history: object = None
    fleet: object = None     # leader-side fleet observatory (obs/fleet.py)
    # set by shutdown under `duties_lock`: a standby promoting on another
    # thread starts no loop once it is set
    stopping: bool = False
    duties_lock: threading.Lock = field(default_factory=threading.Lock)

    def is_leader(self) -> bool:
        return self.selector is not None and self.selector.is_leader


def build_process(
    settings: Settings,
    *,
    clock: Callable[[], int] = wall_clock_ms,
    start_rest: bool = True,
) -> CookProcess:
    device = device_for_platform(settings.platform)
    sharded = settings.shards > 1
    store = None
    if settings.data_dir:
        # failover recovery: load the last snapshot, then replay the
        # journal suffix after it.  Durability bound: mutations committed
        # through the transaction pipeline (txn/ — every REST mutation)
        # are group-fsynced before the call returns, so every acknowledged
        # REST write survives; scheduler-internal events between txn
        # commits ride the journal's batched fsync (JournalWriter.
        # fsync_every) and a crash of the OS (not just the process) may
        # lose up to that many of them.
        from cook_tpu_torch.models import persistence

        os.makedirs(settings.data_dir, exist_ok=True)
        if sharded:
            from cook_tpu_torch.shard import journal as shard_journal

            if shard_journal.has_single_journal_layout(settings.data_dir):
                # exactly-once layout conversion (manifest-stamped)
                outcome = shard_journal.migrate_single_journal(
                    settings.data_dir, settings.shards, clock=clock)
                log_info("migrated data_dir to per-shard journal "
                         "segments", component="startup", **{
                             k: v for k, v in outcome.items()
                             if k != "per_shard_jobs"})
            store = shard_journal.recover_sharded(
                settings.data_dir, settings.shards, clock=clock)
        else:
            store = persistence.recover(settings.data_dir, clock=clock)
        if store is not None:
            store.mea_culpa_limit = settings.mea_culpa_failure_limit
            log_info("recovered store from snapshot+journal",
                     component="startup", jobs=len(store.jobs),
                     **store.recovered_stats)
    if store is None:
        if sharded:
            from cook_tpu_torch.shard import ShardedStore

            store = ShardedStore(
                settings.shards,
                mea_culpa_limit=settings.mea_culpa_failure_limit,
                clock=clock)
        else:
            store = JobStore(
                mea_culpa_limit=settings.mea_culpa_failure_limit,
                clock=clock)
    journal = None
    journals = []
    if settings.data_dir:
        from cook_tpu_torch.models import persistence

        if sharded:
            from cook_tpu_torch.shard import journal as shard_journal

            journals = shard_journal.attach_shard_journals(
                store, settings.data_dir,
                fsync_policy=settings.journal_fsync_policy)
        else:
            journal = persistence.attach_journal(
                store, os.path.join(settings.data_dir, "journal.jsonl"),
                fsync_policy=settings.journal_fsync_policy,
            )
            journals = [journal]
    from cook_tpu_torch.utils.logging import attach_passport

    attach_passport(store)
    for pool_conf in settings.pools:
        store.set_pool(Pool(
            name=pool_conf["name"],
            dru_mode=DruMode(pool_conf.get("dru_mode", "default")),
        ))
    clusters = []
    for conf in settings.clusters:
        factory = CLUSTER_FACTORIES.get(conf.get("kind", "mock"))
        if factory is None:
            raise ValueError(f"unknown cluster kind {conf.get('kind')}")
        clusters.append(factory(conf, clock))
    from cook_tpu_torch.scheduler.plugins import registry_from_config

    plugins = registry_from_config(settings.plugins)
    from cook_tpu_torch.txn import TransactionLog

    # ONE commit pipeline for the process: REST mutations and the
    # elastic capacity plane's pool/capacity-delta commits share the
    # journal-backed log (durable-on-ack for both).  Sharded deployments
    # get the partitioned pipeline — per-shard locks, segments,
    # idempotency — behind the same commit() seam
    if sharded:
        from cook_tpu_torch.shard import ShardedTransactionLog

        txn = ShardedTransactionLog(
            store, journals=journals if journals else None)
    else:
        txn = TransactionLog(store, journal=journal)
    from cook_tpu_torch.elastic import ElasticParams

    elastic_conf = settings.elastic
    elastic_params = ElasticParams(
        enabled=bool(elastic_conf.get(
            "enabled", settings.elastic_interval_s > 0)),
        headroom=float(elastic_conf.get("headroom", 0.1)),
        rank_half_life=int(elastic_conf.get("rank_half_life", 64)),
        reclaim_window=int(elastic_conf.get("reclaim_window", 100)),
        count_block_headroom=bool(
            elastic_conf.get("count_block_headroom", True)),
        gang_block_hosts=int(elastic_conf.get("gang_block_hosts", 0)),
        resident=bool(elastic_conf.get("resident", False)),
    )
    incident_dir = settings.incident_dir
    if not incident_dir and settings.data_dir:
        incident_dir = os.path.join(settings.data_dir, "incidents")
    scheduler = Scheduler(
        store,
        clusters,
        SchedulerConfig(match=settings.match, rebalancer=settings.rebalancer,
                        elastic=elastic_params,
                        speculation=settings.speculation,
                        speculation_horizon_ms=(
                            settings.speculation_horizon_ms),
                        predictor_quantile=settings.predictor_quantile,
                        predictor_window=settings.predictor_window,
                        predictor_min_samples=settings.predictor_min_samples,
                        backfill_weight=settings.backfill_weight,
                        backfill_norm_ms=settings.backfill_norm_ms,
                        incident_capacity=settings.incident_capacity,
                        incident_cooldown_s=settings.incident_cooldown_s,
                        incident_dir=incident_dir,
                        auto_profile=settings.auto_profile,
                        profile_dir=settings.profile_dir),
        plugins=plugins,
        device=device,
        txn=txn,
    )
    # metrics history: durable under data_dir/metrics when persistence
    # is configured, memory-only rings otherwise.  history_sample_s <= 0
    # leaves the instance queryable but unsampled.
    from cook_tpu_torch.obs.tsdb import HistoryConfig, MetricsHistory

    history = MetricsHistory(
        dir=(os.path.join(settings.data_dir, "metrics")
             if settings.data_dir else None),
        config=HistoryConfig.from_retention(settings.history_sample_s,
                                            settings.history_retention),
    ).start()
    from cook_tpu_torch.rest.auth import authenticator_from_config
    api = CookApi(store, scheduler, ApiConfig(
        default_pool=settings.default_pool,
        admins=settings.admins,
        submission_rate_per_minute=settings.submission_rate_per_minute,
        cors_origins=settings.cors_origins,
        authenticator=(authenticator_from_config(settings.auth)
                       if settings.auth else None),
        executor_token=settings.executor_token,
        replication_sync_ack=settings.replication_sync_ack,
        replication_min_acks=settings.replication_min_acks,
        replication_ack_timeout_s=settings.replication_ack_timeout_s,
        replication_ack_liveness_s=settings.replication_ack_liveness_s,
        load_shedding=settings.load_shedding,
        fault_injection=settings.fault_injection,
        replica_reads=settings.replica_reads,
        replica_staleness_ceiling_ms=settings.replica_staleness_ceiling_ms,
        replica_refuse_after_s=settings.replica_refuse_after_s,
        max_gang_size=int(settings.api.get("max_gang_size", 64)),
    ), plugins=plugins, txn=txn, history=history)
    # close the overload loop: the contention observatory's shed signal
    # also drives the scheduler's considerable-window scaleback.  One
    # flag governs BOTH halves of the reaction
    if settings.load_shedding:
        scheduler.admission.overload_fn = api.shedder.overloaded
    api.queue_limits.limits.per_pool = settings.queue_limit_per_pool
    api.queue_limits.limits.per_user_per_pool = settings.queue_limit_per_user
    process = CookProcess(settings=settings, store=store, clusters=clusters,
                          scheduler=scheduler, api=api, journal=journal,
                          journals=journals, history=history,
                          member_id=str(uuid_mod.uuid4())[:8])
    if start_rest:
        process.server = ServerThread(api, port=settings.port).start()
    return process


def start_leader_duties(process: CookProcess,
                        *, on_loss: Optional[Callable[[], None]] = None,
                        block: bool = True) -> None:
    """Acquire leadership, then start the scheduling loops
    (mesos.clj takeLeadership)."""
    settings = process.settings
    advertised = settings.advertised_url \
        or f"http://127.0.0.1:{settings.port}"
    if settings.leader_endpoint:
        # networked election (the ZK-session analog): no shared
        # filesystem between schedulers, only the lease service address
        elector = HttpLeaseElector(
            settings.leader_endpoint, settings.leader_group,
            process.member_id, advertised_url=advertised,
            ttl_s=settings.leader_ttl_s)
    elif settings.leader_lease_path:
        elector = FileLeaseElector(
            settings.leader_lease_path, process.member_id,
            advertised_url=advertised, ttl_s=settings.leader_ttl_s)
    else:
        elector = InMemoryElector("cook", process.member_id)
    process.selector = LeaderSelector(elector, on_loss=on_loss)
    # while standing by, surface the current leader for REST proxying and
    # keep the scheduler passive: replicated events maintain its indexes
    # but must not re-execute the leader's side effects
    process.api.leader = False
    process.scheduler.active = False
    if hasattr(elector, "current_leader_url"):
        process.api.leader_url = elector.current_leader_url()

        # tail the leader's journal so promotion works from OUR copy of
        # the state (the Datomic-replication role, control/replication.py)
        from cook_tpu_torch.control.replication import JournalFollower

        def set_leader_url(url: str) -> None:
            if not process.selector.is_leader:
                process.api.leader_url = url if url != advertised else ""

        if settings.shards > 1:
            # one follower per shard segment (shard/replica.py), each
            # parking its own long-poll on the leader's `?shard=i` feed
            from cook_tpu_torch.shard.replica import ShardedJournalFollower

            process.follower = ShardedJournalFollower(
                process.store,
                leader_url_fn=elector.current_leader_url,
                self_url=advertised,
                data_dir=settings.data_dir,
                journals=process.journals or None,
                as_user=settings.replication_user,
                member_id=process.member_id,
                on_leader_url=set_leader_url,
            ).start()
        else:
            process.follower = JournalFollower(
                process.store,
                leader_url_fn=elector.current_leader_url,
                self_url=advertised,
                data_dir=settings.data_dir,
                journal=process.journal,
                as_user=settings.replication_user,
                member_id=process.member_id,
                on_leader_url=set_leader_url,
            ).start()
        # replica-served reads: heavy GETs on this standby answer from
        # the replayed journal with the follower's staleness bound
        process.api.staleness_fn = process.follower.staleness_view
    process.selector.wait_for_leadership()
    if not process.selector.is_leader:
        return  # stopped while standing by (shutdown during wait)
    if process.follower is not None:
        # full join (stop waits out any in-flight fetch; on a sharded
        # store, every shard follower's): a late response from a deposed
        # leader must not clobber the state we now own
        process.follower.stop()
    # under the lock, so that a shutdown racing this promotion (a standby
    # promoting on its own thread) either stops every loop it starts or
    # finds `stopping` set before any starts
    with process.duties_lock:
        if process.stopping:
            return
        _take_leadership(process)
    if block:
        try:
            while process.selector.is_leader:
                time.sleep(1.0)
        except KeyboardInterrupt:
            pass


def _take_leadership(process: CookProcess) -> None:
    """The promotion invariants, in order, then the leader's loops
    (mesos.clj takeLeadership)."""
    settings = process.settings
    # promotion invariant: the columnar rank index tracked the leader via
    # the replicated-event fan-out (every shard follower's); verify it
    # over the merged view, and rebuild if anything drifted — a promoted
    # standby must schedule from its replicated state immediately (no
    # REST write in between)
    columnar = getattr(process.scheduler, "columnar", None)
    if columnar is not None and not columnar.consistent_with_store():
        log.warning("columnar index inconsistent at promotion; rebuilding")
        columnar.rebuild()
    # elastic promotion invariant: converge every cluster's capacity to
    # the recovered loan ledger — a previous leader may have died between
    # a pool/capacity-delta commit and the cluster resize (scale() is
    # declarative, so this replay is idempotent)
    if process.scheduler.elastic is not None:
        process.scheduler.elastic.reconcile()
    process.scheduler.active = True
    process.api.leader = True
    process.api.leader_url = ""
    # the leader's reads are authoritative — no staleness stamping
    process.api.staleness_fn = None
    log_info("leadership acquired", component="leader",
             member=process.member_id)
    if settings.fleet_poll_s > 0:
        # fleet observatory (obs/fleet.py), a LEADER duty: poll every
        # known peer — the configured Settings.peers list plus every
        # standby that registered itself (with its URL) through the
        # replication ack registry — and serve the merged verdict at
        # GET /debug/fleet.  A peer's ok->degraded edge captures a
        # federated entry in THIS node's incident ring.
        from cook_tpu_torch.obs.fleet import FleetObservatory

        def peer_urls():
            urls = set(settings.peers)
            for meta in list(process.api.replication_ack_meta.values()):
                url = meta.get("url") or ""
                if url.startswith("http"):
                    urls.add(url)
            return sorted(urls)

        process.fleet = FleetObservatory(
            self_url=(settings.advertised_url
                      or f"http://127.0.0.1:{settings.port}"),
            peers_fn=peer_urls,
            poll_s=settings.fleet_poll_s,
            incidents=process.api.incidents,
            self_verdict_fn=process.api.health_verdict,
            as_user=settings.replication_user,
        ).start()
        process.api.fleet = process.fleet
    fail_stop_journals = [
        j for j in (process.journals or [process.journal])
        if j is not None and getattr(j, "fsync_policy", "") == "fail-stop"]
    if fail_stop_journals:
        # reaction (e), docs/resilience.md: under the fail-stop policy a
        # journal fsync FAILURE demotes this leader (fail-fast,
        # mesos.clj:296-313); the failing commit itself already surfaced
        # the error to its client
        def _fsync_fail_stop(exc, _p=process):
            log.error("journal fsync failed (%s): fail-stop leader "
                      "demotion", exc)
            sel = _p.selector
            if sel is None or not sel.is_leader:
                return

            def _demote():
                _p.scheduler.active = False
                _p.api.leader = False
                sel.demote()

            # the hook fires on the committing request's thread, UNDER
            # the journal writer's lock: demote on its own thread so the
            # lease release / on_loss callback never run under that lock
            threading.Thread(target=_demote, daemon=True,
                             name="fsync-fail-stop").start()

        # sharded: ANY segment's disk failing demotes — a leader that
        # can only persist some shards' commits is not a leader
        for fs_journal in fail_stop_journals:
            fs_journal.on_fsync_error = _fsync_fail_stop
    process.selector.start_heartbeat_thread()

    scheduler = process.scheduler
    store = process.store

    def pools():
        return [p for p in store.pools.values() if p.schedules_jobs]

    def rank_all():
        for pool in pools():
            with span("rank_cycle", pool=pool.name):
                scheduler.rank_cycle(pool)

    # round-robin match dispatch (scheduler.clj:2508)
    pool_cycle = itertools.cycle([None])

    def match_next():
        ps = pools()
        if not ps:
            return
        if settings.pipelined_match and len(ps) > 1:
            with span("match_cycle_pipelined", pools=len(ps)):
                scheduler.match_cycle_pipelined()
            return
        if settings.batched_match and len(ps) > 1:
            with span("match_cycle_batched", pools=len(ps)):
                scheduler.match_cycle_all_pools()
            return
        # rebuild the cycle if pools changed
        nonlocal pool_cycle
        current = getattr(match_next, "_pools", None)
        if current != [p.name for p in ps]:
            match_next._pools = [p.name for p in ps]
            pool_cycle = itertools.cycle(ps)
        pool = next(pool_cycle)
        with span("match_cycle", pool=pool.name):
            scheduler.match_cycle(pool)

    def rebalance_all():
        for pool in pools():
            with span("rebalance_cycle", pool=pool.name):
                scheduler.rebalance_cycle(pool)

    # aux publishers/monitors (progress.clj, heartbeat.clj, sandbox.clj,
    # monitor.clj equivalents)
    from cook_tpu_torch.scheduler.heartbeat import HeartbeatMonitor
    from cook_tpu_torch.scheduler.monitor import collect_all
    from cook_tpu_torch.scheduler.progress import ProgressAggregator
    from cook_tpu_torch.scheduler.sandbox import SandboxPublisher

    process.progress_aggregator = ProgressAggregator(store)
    process.sandbox_publisher = SandboxPublisher(store)

    def kill_via_cluster(task_id: str) -> None:
        inst = store.instances.get(task_id)
        if inst is None:
            return
        cluster = scheduler.cluster_by_name(inst.compute_cluster)
        if cluster is not None:
            cluster.safe_kill_task(task_id)

    process.heartbeats = HeartbeatMonitor(store, kill_via_cluster)
    scheduler.heartbeats = process.heartbeats  # REST /heartbeat delivery

    # k8s-style clusters: failover recovery, then the watch
    # (determine-expected-state-on-startup + initialize-pod-watch)
    scannable = _scannable(scheduler.clusters)
    for cluster in scannable:
        start_cluster_backend(cluster, store)

    process.loops = [
        TriggerLoop("rank", settings.rank_interval_s, rank_all).start(),
        TriggerLoop("progress-publish", 2.0,
                    process.progress_aggregator.publish).start(),
        TriggerLoop("sandbox-publish", 5.0,
                    process.sandbox_publisher.publish).start(),
        TriggerLoop("heartbeats", 30.0, process.heartbeats.check).start(),
        TriggerLoop("monitor", 30.0, lambda: collect_all(store)).start(),
    ]
    if settings.health_watch_interval_s > 0:
        # incident watch: evaluate the MERGED health verdict on a clock
        # so ok->degraded transitions capture evidence bundles (and the
        # auto profile) even when no external prober polls /debug/health
        process.loops.append(
            TriggerLoop("health-watch", settings.health_watch_interval_s,
                        lambda: process.api.health_verdict()).start())
    if scannable:
        # periodic anti-entropy scans (scan-process), over the clusters
        # created over REST since, too
        process.loops.append(
            TriggerLoop("k8s-scan", 30.0,
                        lambda: [c.scan_all()
                                 for c in _scannable(scheduler.clusters)]
                        ).start())
    # mock clusters complete tasks by virtual time; in a live service the
    # wall clock drives them (the simulator drives advance_to itself)
    advanceable = [c for c in process.clusters if hasattr(c, "advance_to")]
    if advanceable:
        process.loops.append(
            TriggerLoop(
                "mock-advance", 0.5,
                lambda: [c.advance_to(store.clock()) for c in advanceable],
            ).start()
        )
    if settings.data_dir:
        from cook_tpu_torch.models import persistence

        snap_path = os.path.join(settings.data_dir, "snapshot.json")

        def snapshot_and_rotate():
            if settings.shards > 1:
                from cook_tpu_torch.shard import journal as shard_journal

                # every shard's snapshot, then every segment rotates
                shard_journal.snapshot_sharded(store, settings.data_dir)
                for segment in process.journals:
                    segment.rotate()
                return
            persistence.snapshot(store, snap_path)
            if process.journal is not None:
                process.journal.rotate()

        process.loops.append(
            TriggerLoop("snapshot", settings.snapshot_interval_s,
                        snapshot_and_rotate).start()
        )
    process.loops += [
        TriggerLoop("match",
                    max(settings.match_interval_s / max(len(pools()), 1),
                        0.05),
                    match_next).start(),
        TriggerLoop("rebalancer", settings.rebalancer_interval_s,
                    rebalance_all).start(),
    ]
    if scheduler.elastic is not None and settings.elastic_interval_s > 0:
        def elastic_plan():
            with span("elastic_cycle"):
                scheduler.elastic_cycle()

        process.loops.append(
            TriggerLoop("elastic", settings.elastic_interval_s,
                        elastic_plan).start())
    process.loops += [
        TriggerLoop("lingering", settings.lingering_interval_s,
                    lambda: scheduler.kill_lingering_tasks(store.clock())
                    ).start(),
        TriggerLoop("straggler", settings.straggler_interval_s,
                    lambda: scheduler.kill_stragglers(store.clock())).start(),
        TriggerLoop("cancelled", settings.cancelled_interval_s,
                    scheduler.kill_cancelled_tasks).start(),
    ]
    if settings.optimizer_interval_s > 0:
        from cook_tpu_torch.scheduler.optimizer import OptimizerCycle

        cycle = OptimizerCycle()

        def run_optimizer():
            for pool in pools():
                queue = scheduler.pool_queues.get(pool.name)
                cycle.run(queue.jobs if queue else [],
                          store.running_jobs(pool.name), {})

        process.loops.append(
            TriggerLoop("optimizer", settings.optimizer_interval_s,
                        run_optimizer).start()
        )


def shutdown(process: CookProcess, *, join_s: float = 30.0) -> None:
    """Stop the loops (waiting up to `join_s` for each one's current run
    to end, so no cycle outlives its process's teardown), the fleet
    observatory, the history sampler, a standby's journal follower, the
    election, the REST server and the clusters' apiserver watches, then
    close the journal, or every shard's segment (its unsynced tail
    fsynced)."""
    with process.duties_lock:
        process.stopping = True
    for loop in process.loops:
        loop.stop()
    deadline = time.monotonic() + join_s
    for loop in process.loops:
        loop.join(max(0.0, deadline - time.monotonic()))
    if process.fleet is not None:
        process.fleet.stop()
    if process.history is not None:
        process.history.stop()
    if process.follower is not None:
        process.follower.stop()
    if process.selector is not None:
        process.selector.stop()
    if process.server is not None:
        process.server.stop()
    # backend clients own watch threads (HttpKubeApi): stopped before the
    # journals close, so that no pod event reaches the torn-down store
    for cluster in process.scheduler.clusters:
        api_stop = getattr(getattr(cluster, "api", None), "stop", None)
        if api_stop is not None:
            api_stop()
    for journal in process.journals:
        journal.close()
