"""REST API: the full client-facing surface.

Port of `cook_tpu/rest/api.py` (reference: cook.rest.api, rest/api.clj,
routes at :3649-4016): the same resources, JSON shapes and status codes,
served on the standard library (`rest/http.py`, `rest/server.py`) instead
of aiohttp, which the card's machine does not have:

  /rawscheduler (deprecated alias), /jobs[/:uuid], /instances[/:uuid],
  /group, /share, /quota, /usage, /retry, /queue, /running, /list,
  /unscheduled_jobs, /stats/instances, /pools, /settings, /info,
  /failure_reasons, /progress/:uuid, /heartbeat/:uuid, /metrics,
  /compute-clusters, /incremental-config, /pool-move, /debug and
  /debug/{health, contention, faults, elastic, device, predictions,
  cycles, spans, trace, incidents, history, fleet, fairness, profile},
  /jobs/:uuid/timeline, /swagger-docs, /swagger-ui, /shutdown-leader,
  /replication/{journal, snapshot, ack}, /debug/replica.

The handlers are the reference's, as plain functions: aiohttp's
`async def` / `await` become calls, `web.Request` the shim's `Request`,
`web.json_response` its `json_response`.  The replication half serves
both layouts: the leader's committed-event feed with long-poll and the
snapshot bootstrap (shard i's with `?shard=i` on a sharded store), durable
acks per shard, sync-ack commits that wait once per shard they touched,
and a standby's replica-read gate with the per-shard staleness split.
/debug/fleet serves the leader's fleet observatory (`obs/fleet.py`).

Concurrency.  aiohttp runs every handler on one event loop, so the
reference's API-level state (the shedder, the rate limiters, the queue
limits, the incident and profile state, commit batching) is only ever
touched from one thread at a time.  `ThreadingHTTPServer` runs requests
on parallel threads, so the port mirrors the loop with ONE lock,
`CookApi.loop`: every request runs its middlewares and handler holding it,
and releases it exactly where the reference awaits a blocking call in an
executor (the commit pipeline, `_run_commit`, whose fsync must not stall
other requests and whose group commit merges concurrent ones).  Reading
the request body and writing the response happen outside it, as they do
off the loop in aiohttp.  The scheduler's loops never take it: they share
the store, and its own lock, with the handlers.

Parked waits.  The reference parks a replication long-poll (up to
`REPLICATION_MAX_WAIT_S`) and a sync-ack commit's wait for standby acks
on its event loop, which serves other requests meanwhile — among them
the standby's POST /replication/ack that ends the wait.  The port parks
both on `_repl_cond` with the loop lock released (`_repl_wait`), so they
hold no other request back; the snapshot and event encodes run with it
released too.  A waiter reads the wakeup counter `_repl_gen`, tests its
predicate (the journal window, or the ack registries) under the loop
lock, and parks until the counter moves or its deadline passes.

Lock order.  Loop lock -> store lock (a handler reading; on a sharded
store, one shard lock at a time); store lock -> `_repl_cond` (the store
watcher `_on_store_event`, which runs on the committing thread under the
store lock, or its shard's, and only bumps the counter); loop lock ->
`_repl_cond` (an ack).  A commit runs with the loop lock released, and a
cross-shard commit takes its shard locks in ascending shard id
(`shard/txn.py`).  `_repl_cond` is a leaf: nothing is acquired while it
is held, and no thread waits on it while holding the loop lock or the
store lock.

Auth mirrors the reference's pluggable schemes: the requesting user comes
from HTTP basic auth or the X-Cook-Requesting-User dev header, with
X-Cook-Impersonate honored for configured admins.
"""
from __future__ import annotations

import dataclasses
import json
import re
import statistics
import threading
import time
import uuid as uuid_mod
from dataclasses import dataclass
from typing import Optional

from cook_tpu_torch.cluster.base import ClusterState
from cook_tpu_torch.models.entities import (
    Application,
    Checkpoint,
    Container,
    Group,
    GroupPlacementType,
    HostPlacement,
    Instance,
    Job,
    JobConstraint,
    ConstraintOperator,
    Quota,
    Resources,
    Share,
    StragglerHandling,
    job_display,
    new_uuid,
)
from cook_tpu_torch.models.reasons import _REASONS, REASONS_BY_CODE
from cook_tpu_torch.models.state import all_attempts_consumed, attempts_consumed
from cook_tpu_torch.models.store import JobStore, TransactionVetoed
from cook_tpu_torch.obs import distributed
from cook_tpu_torch.obs.contention import (
    ContentionObservatory,
    ContentionParams,
    EndpointTelemetry,
)
from cook_tpu_torch.rest.http import Application as WebApplication
from cook_tpu_torch.rest.http import (
    HTTPException,
    HTTPTemporaryRedirect,
    LoopLock,
    Request,
    Response,
    json_response,
)
from cook_tpu_torch.scheduler.core import Scheduler
from cook_tpu_torch.scheduler.plugins import PluginRegistry
from cook_tpu_torch.scheduler.queue_limit import QueueLimitChecker
from cook_tpu_torch.scheduler.ratelimit import (
    TokenBucketRateLimiter,
    UnlimitedRateLimiter,
)
from cook_tpu_torch.shard.router import MisroutedKey
from cook_tpu_torch.txn import TransactionLog, TxnOutcome
from cook_tpu_torch.utils.metrics import global_registry


@dataclass
class ApiConfig:
    default_pool: str = "default"
    max_job_mem: float = 512_000.0       # MB
    max_job_cpus: float = 512.0
    max_job_gpus: float = 64.0
    max_retries_limit: int = 200
    # largest accepted gang (gang_size=k all-or-nothing placement,
    # scheduler/gang.py) — bounded by what one topology block can hold
    max_gang_size: int = 64
    admins: tuple = ("admin",)
    version: str = "cook-tpu-0.1.0"
    submission_rate_per_minute: float = 0.0  # 0 = unlimited
    # origins allowed to make credentialed cross-origin requests
    # (reference: rest/cors.clj).  Entries are exact origins, or regexes
    # when prefixed with "re:" ("re:https://.*\\.corp\\.example") — exact
    # entries are never regex-interpreted, so an unescaped "." cannot let
    # lookalike origins through.  Empty = CORS disabled.
    cors_origins: tuple = ()
    # injectable request authenticator (rest/auth.py); None = the
    # permissive dev stack (basic auth, then dev header, then anonymous)
    authenticator: object = None
    # shared secret executors present (X-Cook-Executor-Token) on their
    # heartbeat/progress posts; when set, those endpoints are only
    # auth-exempt for callers carrying it
    executor_token: str = ""
    # sync-ack replication (the reference's durable-on-ack semantics,
    # datomic.clj:79 transact-with-retries: a write survives leader death
    # the moment the REST call returns).  When enabled, EVERY mutating
    # endpoint (all committed through cook_tpu_torch.txn) blocks until
    # >= replication_min_acks standbys have ACKed a sequence number
    # covering the commit, or the timeout lapses — a timeout still
    # commits (the write is applied and journaled locally) but the
    # response carries "replicated": false (JSON bodies) or
    # X-Cook-Replicated: false (204s) so callers know the durability
    # bound was not met.
    replication_sync_ack: bool = False
    replication_min_acks: int = 1
    replication_ack_timeout_s: float = 5.0
    # acks older than this stop counting toward min_acks (and are
    # pruned): a decommissioned standby's last ack must not satisfy the
    # durability bound forever.  <= 0 disables liveness qualification.
    replication_ack_liveness_s: float = 30.0
    # thresholds for the control-plane contention health checks
    # (store-lock-saturation, fsync-stall, replication-lag,
    # commit-ack-slo-burn, job-starvation); None = defaults
    contention: Optional[ContentionParams] = None
    # overload load shedding (faults/reactions.py): while commit-ack SLO
    # burn or store-lock saturation is active, heavy read endpoints
    # answer 429 + Retry-After instead of piling onto the saturated store
    # lock; mutations are never shed
    load_shedding: bool = True
    shed_retry_after_s: float = 5.0
    # POST /debug/faults (arm/disarm the process fault schedule) — OFF
    # by default and admin-only when on; never enable in production
    # outside a chaos drill
    fault_injection: bool = False
    # replica-served reads (shard/replica.py): a non-leader with a
    # journal follower serves heavy read endpoints from its replayed
    # state, advertising bounded staleness (X-Cook-Staleness-Ms +
    # staleness_ms in JSON-object bodies).  Above the freshness ceiling
    # the read falls back to the leader (307); a replica that stopped
    # applying for replica_refuse_after_s refuses reads (503) instead of
    # serving stale forever.
    replica_reads: bool = True
    replica_staleness_ceiling_ms: float = 5000.0
    replica_refuse_after_s: float = 30.0


class CookApi:
    def __init__(
        self,
        store: JobStore,
        scheduler: Optional[Scheduler] = None,
        config: Optional[ApiConfig] = None,
        plugins: Optional[PluginRegistry] = None,
        txn: Optional[TransactionLog] = None,
        history=None,
    ):
        self.store = store
        self.scheduler = scheduler
        self.config = config or ApiConfig()
        self.plugins = plugins or PluginRegistry()
        # the event loop's stand-in (module docstring): held by every
        # request, released around the commit pipeline
        self.loop = LoopLock()
        # the durable commit pipeline every mutating handler goes through
        # (components.py wires the journal in; a bare CookApi commits
        # in-memory only)
        self.txn = txn or TransactionLog(store)
        self.queue_limits = QueueLimitChecker(store)
        if self.config.submission_rate_per_minute > 0:
            self.submission_limiter = TokenBucketRateLimiter(
                tokens_replenished_per_minute=self.config.submission_rate_per_minute,
                bucket_size=self.config.submission_rate_per_minute,
                clock=store.clock,
            )
        else:
            self.submission_limiter = UnlimitedRateLimiter()
        if self.config.authenticator is not None:
            self.authenticator = self.config.authenticator
        else:
            from cook_tpu_torch.rest.auth import dev_default_authenticator

            self.authenticator = dev_default_authenticator()
        self.leader = True
        self.leader_url = ""  # set on standbys for leader proxying
        # replication feed identity: event sequence numbers are only
        # comparable within one leader history, so every process stamps
        # its feed with a fresh incarnation; followers force a snapshot
        # bootstrap when it changes (a deposed leader may hold committed
        # events the new leader never saw — silent divergence otherwise)
        self.incarnation = uuid_mod.uuid4().hex[:12]
        # follower -> highest event seq it has confirmed applied AND
        # journaled locally (POST /replication/ack with durable=true);
        # read by sync-ack commits.  Acks from followers without local
        # durability (no journal/data_dir) are tracked in
        # replication_ack_meta only — they must not satisfy min_acks,
        # or "replicated: true" would not mean what it says.
        self.replication_acks: dict[str, int] = {}
        # shard -> follower -> highest durable acked seq ON THAT SHARD
        # (the reference's sharded layout; unsharded acks land under
        # shard 0, so the same await path serves both)
        self.replication_shard_acks: dict[int, dict[str, int]] = {}
        # (follower, shard) -> {seq, durable, time(monotonic), ...} for
        # every ack seen; liveness pruning keys off `time`
        self.replication_ack_meta: dict[str, dict] = {}
        # replica-served reads (shard/replica.py): a standby's wiring
        # (components.py) points this at its journal follower's
        # staleness_view; None = no replica-read surface on this node
        self.staleness_fn = None
        # merged-trace process identity (obs/distributed.py): an mp worker
        # stamps "worker-gN" here so this node's REST-side spans route to
        # its pid track; None on single-process servers
        self.process_label = None
        # long-poll / sync-ack wakeups (module docstring, "Lock order"):
        # a generation counter bumped under its own condition by every
        # commit (the store watcher) and every ack; waiters park on the
        # condition with the loop lock released
        self._repl_cond = threading.Condition()
        self._repl_gen = 0
        self._repl_closed = False
        store.add_watcher(self._on_store_event)
        # control-plane contention observatory (obs/contention.py):
        # per-route REST telemetry (fed by the outermost middleware),
        # store-lock / journal / replication / commit-ack attribution —
        # served at GET /debug/contention and folded into /debug/health
        self.endpoints = EndpointTelemetry()
        self.contention = ContentionObservatory(
            store,
            params=self.config.contention,
            endpoints=self.endpoints,
            journal_fn=lambda: getattr(
                getattr(self.txn, "journal", None), "telemetry", None),
            # a copy: the health-watch loop reads it off the loop lock
            replication_meta_fn=lambda: dict(self.replication_ack_meta),
            starvation_fn=self._starvation_view,
        )
        if hasattr(self.txn, "shard_view"):
            # sharded pipeline (shard/txn.ShardedTransactionLog):
            # per-shard lock/journal/commit attribution rides the same
            # /debug/contention surface
            self.contention.shards_fn = (
                lambda: self.txn.shard_view(self.contention.params))
        self._replica_refusals = global_registry.counter(
            "shard.replica_reads_refused",
            "replica reads refused because the replica stopped applying")
        self._replica_fallbacks = global_registry.counter(
            "shard.replica_reads_fallback",
            "replica reads redirected to the leader over the staleness "
            "ceiling")
        # overload reaction: heavy reads shed while the SLO burns
        # (faults/reactions.py; also the scheduler's admission-scaleback
        # signal — components.py wires overload_fn to this)
        from cook_tpu_torch.faults.reactions import LoadShedder

        self.shedder = LoadShedder(
            self.contention,
            retry_after_s=self.config.shed_retry_after_s)
        # incident observatory (obs/incident.py): adopt the scheduler's
        # recorder (it already collects cycles/trace/faults) or stand up a
        # control-plane-only one; either way this layer contributes the
        # /debug/contention snapshot as bundle evidence
        from cook_tpu_torch.obs.incident import (IncidentRecorder,
                                                 add_default_collectors)

        self.incidents = getattr(scheduler, "incidents", None)
        self.profiler = getattr(scheduler, "profiler", None)
        if self.incidents is None:
            self.incidents = add_default_collectors(IncidentRecorder())
        self.incidents.add_collector("contention", self.contention.snapshot)
        # durable multi-resolution metrics history (obs/tsdb.py):
        # components.py passes the data_dir-backed, sampler-started
        # instance; a bare CookApi gets a memory-only one so
        # GET /debug/history always serves.  Every bundle embeds the
        # pre-incident slice of the key series
        if history is None:
            from cook_tpu_torch.obs.tsdb import MetricsHistory

            history = MetricsHistory()
        self.history = history
        self.incidents.add_collector("history", self.history.incident_slice)
        # fleet observatory (obs/fleet.py): the leader's wiring
        # (components.py) attaches a started FleetObservatory; None =
        # this node does not federate (GET /debug/fleet says so)
        self.fleet = None
        # fairness observatory (obs/fairness.py): adopt the scheduler's
        # (rank/rebalance cycles feed it) or stand up a local one on
        # scheduler-less nodes, so the incident bundle carries fairness
        # evidence either way
        self.fairness = getattr(scheduler, "fairness", None)
        if self.fairness is None:
            from cook_tpu_torch.obs.fairness import FairnessObservatory

            self.fairness = FairnessObservatory(clock=store.clock)
            self.fairness.recover(store)
            self.incidents.add_collector("fairness", self.fairness.collector)

    def _starvation_view(self) -> dict:
        from cook_tpu_torch.scheduler.monitor import starvation_stats

        return {pool: starvation_stats(self.store, pool)
                for pool in sorted(self.store.pools)}

    # ------------------------------------------------------------ app wiring

    def build_app(self) -> WebApplication:
        # endpoint telemetry sits OUTSIDE auth so rejected requests are
        # measured too; middlewares apply in list order
        app = WebApplication(middlewares=[self._endpoint_middleware,
                                          self._auth_middleware,
                                          self._replica_middleware],
                             loop=self.loop)
        r = app.router
        for path in ("/rawscheduler", "/jobs"):
            r.add_get(path, self.get_jobs)
            r.add_post(path, self.post_jobs)
            r.add_delete(path, self.delete_jobs)
        r.add_get("/jobs/{uuid}", self.get_job)
        r.add_get("/instances/{uuid}", self.get_instance)
        r.add_get("/instances", self.get_instances)
        r.add_delete("/instances", self.delete_instances)
        r.add_get("/group", self.get_groups)
        r.add_delete("/group", self.delete_groups)
        r.add_get("/share", self.get_share)
        r.add_post("/share", self.post_share)
        r.add_delete("/share", self.delete_share)
        r.add_get("/quota", self.get_quota)
        r.add_post("/quota", self.post_quota)
        r.add_delete("/quota", self.delete_quota)
        r.add_get("/usage", self.get_usage)
        r.add_post("/pool-move", self.post_pool_move)
        r.add_get("/retry", self.get_retry)
        r.add_post("/retry", self.post_retry)
        r.add_put("/retry", self.post_retry)
        r.add_get("/queue", self.get_queue)
        r.add_get("/running", self.get_running)
        r.add_get("/list", self.get_list)
        r.add_get("/unscheduled_jobs", self.get_unscheduled)
        r.add_get("/stats/instances", self.get_instance_stats)
        r.add_get("/pools", self.get_pools)
        r.add_get("/settings", self.get_settings)
        r.add_get("/info", self.get_info)
        r.add_get("/failure_reasons", self.get_failure_reasons)
        r.add_get("/progress/{uuid}", self.get_progress)
        r.add_post("/progress/{uuid}", self.post_progress)
        r.add_post("/heartbeat/{uuid}", self.post_heartbeat)
        r.add_get("/metrics", self.get_metrics)
        r.add_get("/compute-clusters", self.get_compute_clusters)
        r.add_post("/compute-clusters", self.post_compute_cluster)
        r.add_delete("/compute-clusters/{name}", self.delete_compute_cluster)
        r.add_get("/incremental-config", self.get_incremental_config)
        r.add_post("/incremental-config", self.post_incremental_config)
        r.add_post("/shutdown-leader", self.post_shutdown_leader)
        r.add_get("/replication/journal", self.get_replication_journal)
        r.add_get("/replication/snapshot", self.get_replication_snapshot)
        r.add_post("/replication/ack", self.post_replication_ack)
        r.add_get("/debug", self.get_debug)
        r.add_get("/debug/replica", self.get_debug_replica)
        r.add_get("/debug/health", self.get_debug_health)
        r.add_get("/debug/contention", self.get_debug_contention)
        r.add_get("/debug/faults", self.get_debug_faults)
        r.add_post("/debug/faults", self.post_debug_faults)
        r.add_get("/debug/elastic", self.get_debug_elastic)
        r.add_get("/debug/device", self.get_debug_device)
        r.add_get("/debug/predictions", self.get_debug_predictions)
        r.add_get("/debug/cycles", self.get_debug_cycles)
        r.add_get("/debug/cycles/{cycle_id}", self.get_debug_cycle)
        r.add_get("/debug/spans", self.get_debug_spans)
        r.add_get("/debug/trace", self.get_debug_trace)
        r.add_get("/debug/incidents", self.get_debug_incidents)
        r.add_get("/debug/incidents/{incident_id}", self.get_debug_incident)
        r.add_get("/debug/history", self.get_debug_history)
        r.add_get("/debug/fleet", self.get_debug_fleet)
        r.add_get("/debug/fairness", self.get_debug_fairness)
        r.add_get("/debug/profile", self.get_debug_profile)
        r.add_post("/debug/profile", self.post_debug_profile)
        r.add_get("/jobs/{uuid}/timeline", self.get_job_timeline)
        r.add_get("/swagger-docs", self.get_swagger_docs)
        r.add_get("/swagger-ui", self.get_swagger_ui)
        self._openapi = _build_openapi(app)
        return app

    def get_swagger_docs(self, request: Request) -> Response:
        """Machine-readable API description (reference serves swagger at
        the same paths, rest/api.clj:3650)."""
        return json_response(self._openapi)

    def get_swagger_ui(self, request: Request) -> Response:
        rows = []
        for path, methods in sorted(self._openapi["paths"].items()):
            for method, info in sorted(methods.items()):
                rows.append(
                    f"<tr><td><code>{method.upper()}</code></td>"
                    f"<td><code>{path}</code></td>"
                    f"<td>{info.get('summary', '')}</td></tr>"
                )
        html = (
            "<html><head><title>cook-tpu API</title></head><body>"
            "<h1>cook-tpu REST API</h1>"
            "<p>Machine-readable spec: <a href='/swagger-docs'>"
            "/swagger-docs</a></p>"
            "<table border=1 cellpadding=4><tr><th>Method</th><th>Path</th>"
            "<th>Handler</th></tr>" + "".join(rows) + "</table></body></html>"
        )
        return Response(text=html, content_type="text/html")

    def get_debug(self, request: Request) -> Response:
        """Health endpoint (reference components.clj:141): 200 when the
        process serves; includes leadership so load balancers can route
        writes to the leader."""
        return json_response({
            "healthy": True,
            "leader": bool(self.scheduler) and self.leader,
        })

    def _recorder(self):
        return getattr(self.scheduler, "recorder", None) \
            if self.scheduler is not None else None

    def _telemetry(self):
        return getattr(self.scheduler, "telemetry", None) \
            if self.scheduler is not None else None

    def get_debug_health(self, request: Request) -> Response:
        """Health verdict: the device-telemetry degradations (recompile-
        storm, quality-drift, solve-latency-regression, device-oom-risk)
        merged with the control-plane contention degradations (store-
        lock-saturation, fsync-stall, replication-lag,
        commit-ack-slo-burn, job-starvation), each with per-check
        evidence.  Always 200; `healthy`/`status` carry the verdict so
        probes distinguish "degraded" from "down".  With device telemetry
        disabled (device_telemetry=False, or no scheduler attached — a
        proxy-only node) the device side reports "unobserved" while the
        contention checks still run — the control plane is observable on
        every node."""
        return json_response(self.health_verdict())

    def health_verdict(self) -> dict:
        """Compute the MERGED health verdict (device telemetry +
        contention) and report it to the incident observatory — shared by
        the REST handler and the health-watch trigger loop
        (components.py), so incident capture doesn't depend on an
        external prober hitting /debug/health at the right moment."""
        telemetry = self._telemetry()
        if telemetry is None:
            verdict = {
                "healthy": True,
                "status": "unobserved",
                "degradations": [],
                "reasons": [],
                "checks": {},
            }
        else:
            # observe=False: the incident observatory must see ONE
            # verdict per evaluation — the merged one below — or a
            # contention-only degradation would read as an ok->degraded
            # flap on every probe
            verdict = telemetry.health(observe=False)
        degradations, checks = self.contention.evaluate()
        # fairness drift (obs/fairness.py): a sustained Jain-index drop
        # joins the merged verdict the same way the contention half does
        fair_degradations = self.fairness.health_degradations()
        degradations = degradations + fair_degradations
        verdict["degradations"] = verdict["degradations"] + degradations
        verdict["checks"]["contention"] = checks
        verdict["checks"]["fairness"] = self.fairness.health_checks()
        verdict["reasons"] = sorted(
            set(verdict["reasons"]) | {d["reason"] for d in degradations})
        if degradations:
            verdict["healthy"] = False
            verdict["status"] = "degraded"
        # the rollup gauge must reflect the MERGED verdict (the device-
        # side HealthMonitor already set it from its own half)
        global_registry.gauge(
            "obs.health.degraded",
            "1 while /debug/health reports any degradation reason").set(
            0.0 if verdict["healthy"] else 1.0)
        self.incidents.observe(verdict)
        return verdict

    def _shed(self, route: str) -> Optional[Response]:
        """Load-shedding gate for heavy read endpoints: 429 + Retry-After
        while a shed-relevant degradation (commit-ack-slo-burn,
        store-lock-saturation) is active.  Mutations and cheap probes
        are never routed through here."""
        if not self.config.load_shedding:
            return None
        verdict = self.shedder.should_shed(route)
        if verdict is None:
            return None
        response = _err(429, verdict["detail"])
        response.headers["Retry-After"] = str(
            max(1, int(verdict["retry_after_s"])))
        return response

    def get_debug_faults(self, request: Request) -> Response:
        """The armed fault schedule (rule state + firing counts).
        Readable whenever fault injection is enabled."""
        from cook_tpu_torch import faults

        if not self.config.fault_injection:
            return _err(403, "fault injection is disabled "
                             "(ApiConfig.fault_injection)")
        active = faults.ACTIVE
        return json_response({
            "enabled": True,
            "armed": active is not None,
            "schedule": active.to_dict() if active is not None else None,
        })

    def post_debug_faults(self, request: Request) -> Response:
        """Arm ({"seed": .., "rules": [...]}) or disarm ({"disarm":
        true}) the process-global fault schedule.  Admin-only, and gated
        behind ApiConfig.fault_injection — this endpoint exists for
        chaos drills (docs/resilience.md), not production traffic."""
        from cook_tpu_torch import faults

        if not self.config.fault_injection:
            return _err(403, "fault injection is disabled "
                             "(ApiConfig.fault_injection)")
        if request["user"] not in self.config.admins:
            return _err(403, f"user {request['user']} is not an admin")
        body = request.json()
        if body.get("disarm"):
            faults.disarm()
            return json_response({"armed": False})
        try:
            schedule = faults.FaultSchedule.from_dict(body)
        except (KeyError, TypeError, ValueError) as e:
            return _err(400, f"bad fault schedule: {e}")
        faults.arm(schedule)
        return json_response({"armed": True,
                              "schedule": schedule.to_dict()})

    def get_debug_contention(self, request: Request) -> Response:
        """Control-plane contention snapshot (cook_tpu/obs/contention):
        where the write path's time goes — store-lock wait/hold per call
        site (current holder, longest waiter, contention ratio), journal
        append/fsync pipeline, per-follower replication lag, per-route
        REST latency/RPS/in-flight, and the commit-ack SLO burn rate.
        The before/after instrument for the control-plane sharding work
        (ROADMAP item 2)."""
        return json_response(self.contention.snapshot())

    def get_debug_elastic(self, request: Request) -> Response:
        """Elastic capacity plane state (cook_tpu/elastic/): the durable
        loan ledger, the ledger-derived net adjustment per pool, and the
        planner's recent decisions (interval plans + on-demand reclaims,
        `?limit=` bounds, `?kind=` filters).  The ledger renders even
        when the planner is disabled — a standby's replicated ledger is
        inspectable before promotion."""
        try:
            limit = max(1, int(request.query.get("limit", "50")))
        except ValueError:
            return _err(400, "limit must be an integer")
        elastic = getattr(self.scheduler, "elastic", None) \
            if self.scheduler is not None else None
        body = {
            "enabled": elastic is not None,
            "ledger": self.store.encoded_capacity_ledger(),
            "net": {pool: self.store.net_capacity_adjustment(pool)
                    for pool in sorted(self.store.pools)},
            "plans": (elastic.recorder.records_json(
                limit=limit, kind=request.query.get("kind"))
                if elastic is not None else []),
        }
        return json_response(body)

    def get_debug_device(self, request: Request) -> Response:
        """Device data-plane observatory (obs/data_plane.py):
        host<->device transfer totals per tensor family (the matcher's
        audit puts bucketed separately under `fallback`), the per-pool
        residency ledger (`rebuild_fraction`), padding waste per (op,
        padded bucket), recent per-cycle byte summaries, and the device-
        resident match state (scheduler/device_state.py).  `roofline` is
        empty: its rows are XLA's cost analysis, which has no counterpart
        here (`chip_smoke.py` computes each kernel's bound instead).
        Reads host-side ledgers only: nothing here waits on the card."""
        from cook_tpu_torch.obs import data_plane
        from cook_tpu_torch.scheduler import device_state as _device_state

        body = data_plane.LEDGER.snapshot()
        telemetry = self._telemetry()
        body["roofline"] = []
        body["device_telemetry"] = telemetry is not None
        body["device_state"] = _device_state.snapshot_all()
        return json_response(body)

    def get_debug_predictions(self, request: Request) -> Response:
        """Prediction-assisted speculation surface (scheduler/
        prediction.py): the runtime predictor's key/observation counts
        and the speculator's dispatch/hit/drop tallies (drop reasons
        included) — the operator view of how much of the match load is
        being served ahead of the cycle clock."""
        scheduler = self.scheduler
        predictor = getattr(scheduler, "predictor", None) \
            if scheduler is not None else None
        speculator = getattr(scheduler, "speculator", None) \
            if scheduler is not None else None
        return json_response({
            "enabled": speculator is not None,
            "predictor": (predictor.stats_json()
                          if predictor is not None else None),
            "speculation": (speculator.stats_json()
                            if speculator is not None else None),
        })

    def get_debug_cycles(self, request: Request) -> Response:
        """Flight-recorder ring: per-cycle structured decision records
        (per-phase durations, per-job reason codes, preemption victims).
        `?limit=` bounds the reply, `?pool=` filters, `?since=` keeps
        only records with cycle id > since (incremental polling)."""
        recorder = self._recorder()
        if recorder is None:
            return _err(503, "no scheduler/flight recorder attached")
        try:
            limit = int(request.query.get("limit", "50"))
            since = int(request.query.get("since", "0"))
        except ValueError:
            return _err(400, "limit/since must be integers")
        pool = request.query.get("pool")
        return json_response({
            "cycles": recorder.records_json(limit=max(1, limit), pool=pool,
                                        since=since),
            "capacity": recorder.capacity,
        })

    def get_debug_cycle(self, request: Request) -> Response:
        """One full cycle record by id."""
        recorder = self._recorder()
        if recorder is None:
            return _err(503, "no scheduler/flight recorder attached")
        try:
            cycle_id = int(request.match_info["cycle_id"])
        except ValueError:
            return _err(400, "cycle id must be an integer")
        record = recorder.get_json(cycle_id)
        if record is None:
            return _err(404, f"cycle {cycle_id} not in the recorder ring")
        return json_response(record)

    def get_debug_spans(self, request: Request) -> Response:
        """Recent span-ring entries; `?txn_id=` filters to one correlation
        id (the client's X-Cook-Txn-Id) so a mutation's spans — REST
        commit, txn apply, store ops — read as one linked trace."""
        from cook_tpu_torch.utils import tracing

        try:
            limit = max(1, int(request.query.get("limit", "100")))
        except ValueError:
            return _err(400, "limit must be an integer")
        txn_id = request.query.get("txn_id")
        spans = tracing.recent_spans(
            limit=tracing.ring_capacity() if txn_id else limit)
        if txn_id:
            spans = [s for s in spans
                     if s.get("tags", {}).get("txn_id") == txn_id][-limit:]
        return json_response({"spans": spans})

    def get_debug_trace(self, request: Request) -> Response:
        """Span-ring export.  `?format=chrome` (default) renders the ring
        as a Chrome-trace/Perfetto-loadable event file — host threads and
        pools become tracks, every ring tag (txn_id included) rides in
        the event args; `?format=raw` returns the ring entries verbatim.
        `?limit=` bounds how many (newest) spans export; `?txn_id=`
        slices the ring by correlation id first — the per-process half
        of the mp front end's federated trace merge
        (docs/observability.md, cross-process tracing)."""
        from cook_tpu_torch.utils import tracing

        try:
            limit = max(1, int(request.query.get(
                "limit", str(tracing.ring_capacity()))))
        except ValueError:
            return _err(400, "limit must be an integer")
        txn_id = request.query.get("txn_id")
        if txn_id:
            spans = tracing.spans_for_txn(txn_id, limit=limit)
        else:
            spans = tracing.recent_spans(limit=limit)
        fmt = request.query.get("format", "chrome")
        if fmt == "chrome":
            return json_response(tracing.chrome_trace(spans=spans))
        if fmt == "raw":
            return json_response(
                {"spans": spans, "process": self.process_label,
                 "txn_id": txn_id})
        return _err(400, f"unknown format {fmt!r} (chrome | raw)")

    def get_debug_incidents(self, request: Request) -> Response:
        """Incident-bundle index: one summary per captured bundle
        (id, wall time, trigger, reasons, recovery stamp), newest last.
        Full bundles at /debug/incidents/{id}."""
        return json_response({
            "incidents": self.incidents.bundles(),
            "capacity": self.incidents.capacity,
            "cooldown_s": self.incidents.cooldown_s,
            "dir": self.incidents.dir,
        })

    def get_debug_incident(self, request: Request) -> Response:
        """One full incident bundle: the degraded verdict plus every
        evidence collector's snapshot (contention, cycle records,
        chrome-trace export, armed faults, profile capture outcome)."""
        incident_id = request.match_info["incident_id"]
        bundle = self.incidents.get(incident_id)
        if bundle is None:
            return _err(404, f"incident {incident_id} not retained")
        return json_response(bundle, dumps=lambda d: json.dumps(
            d, default=str))

    def get_debug_history(self, request: Request) -> Response:
        """Durable multi-resolution metrics history (cook_tpu/obs/tsdb.py):
        `?metric=` selects series (exact series key, base name, or a
        trailing-`*` prefix), `?since=` bounds the window (epoch seconds;
        negative = relative, -600 = last ten minutes), `?step=` picks the
        resolution (`raw` | `1m` | `10m` — rollup buckets carry
        min/max/mean/last/count).  Without `metric`, serves the series
        index (every tracked series with its point count) — the
        discovery surface `cs history` tab-completes from."""
        metric = request.query.get("metric", "")
        step = request.query.get("step", "raw")
        try:
            since = float(request.query.get("since", "0") or 0)
        except ValueError:
            return _err(400, "since must be a number (epoch seconds, or "
                             "negative for relative)")
        from cook_tpu_torch.obs.tsdb import STEPS

        body = {
            "enabled": True,
            "sample_s": self.history.config.sample_s,
            "steps": list(STEPS),
        }
        if not metric:
            body["series"] = self.history.series_index()
            return json_response(body)
        try:
            body.update(self.history.query(metric, since=since, step=step))
        except ValueError as e:
            return _err(400, str(e))
        return json_response(body)

    def get_debug_fleet(self, request: Request) -> Response:
        """Merged fleet verdict (obs/fleet.py): one row per node (self +
        every polled peer) with poll-age staleness, federation-level
        reasons (`peer-unreachable` / `peer-degraded` with the peer's own
        reasons attached), and the worst replication shard across the
        fleet.  `enabled: false` on nodes without a fleet observatory
        (non-leaders, or `fleet_poll_s` <= 0)."""
        if self.fleet is None:
            return json_response({
                "enabled": False,
                "nodes": [],
                "reasons": [],
                "detail": "no fleet observatory on this node (leader-only "
                          "duty; Settings.peers / fleet_poll_s)",
            })
        return json_response(self.fleet.verdict())

    def get_debug_fairness(self, request: Request) -> Response:
        """Fairness observatory (cook_tpu/obs/fairness.py): per-(pool,
        user) DRU trajectories (share, quota, usage, DRU score, queued
        depth), the preemption ledger (preemptor/victim users, DRU at
        decision, wasted-work seconds), per-pool rollups + Jain
        fairness index + fragmentation stat.  `?pool=` narrows to one
        pool; `?ledger=` bounds the ledger tail (default 50).  Body is
        pool-keyed so the mp front end scatter-merges shard groups."""
        pool = request.query.get("pool")
        try:
            ledger_limit = int(request.query.get("ledger", "50"))
        except ValueError:
            return _err(400, "ledger must be an integer")
        return json_response(
            self.fairness.snapshot(pool=pool, ledger_limit=ledger_limit))

    def get_debug_profile(self, request: Request) -> Response:
        """Profile-capture status: the in-flight capture (if any), recent
        captures with their log dirs, and the auto-capture cooldown."""
        if self.profiler is None:
            return json_response({"enabled": False,
                                  "reason": "no scheduler attached"})
        return json_response({"enabled": True,
                              **self.profiler.status()})

    def post_debug_profile(self, request: Request) -> Response:
        """Start one duration-bounded device profile capture
        ({"duration_s": N}, clamped to the capturer's max).  Admin-only,
        single-flight: a capture already in flight answers 409 with its
        identity instead of corrupting it."""
        if self.profiler is None:
            return _err(503, "no scheduler/profiler attached")
        if request["user"] not in self.config.admins:
            return _err(403, f"user {request['user']} is not an admin")
        body = request.json() if request.can_read_body else {}
        try:
            duration = float(body.get("duration_s", 0) or 0) or None
        except (TypeError, ValueError):
            return _err(400, "duration_s must be a number")
        result = self.profiler.capture(duration, trigger="rest")
        if result["started"]:
            status = 202
        elif result["reason"] == "capture-in-flight":
            # the documented retry-later case; clients poll GET status
            status = 409
        elif result["reason"].startswith("profiler-error"):
            status = 503
        else:  # bad input (e.g. non-positive duration)
            status = 400
        return json_response(result, status=status)

    def get_job_timeline(self, request: Request) -> Response:
        """One job's causally-ordered lifecycle: submit, per-cycle
        rank/skip decisions (consecutive same-reason cycles compressed,
        e.g. "12 cycles skipped: insufficient-resources"), launches,
        preemptions, re-queues — with waiting-time attribution and phase
        latencies (cook_tpu/obs/incident.job_timeline)."""
        from cook_tpu_torch.obs.incident import job_timeline

        job = self.store.jobs.get(request.match_info["uuid"])
        if job is None:
            return _err(404, "unknown job")
        return json_response(job_timeline(self.store, self._recorder(),
                                          job, fairness=self.fairness))

    def _endpoint_middleware(self, request: Request, handler):
        """Per-endpoint REST telemetry: latency / RPS / in-flight /
        error-rate per matched route template (bounded label set — the
        route table, not the workload).  HTTPExceptions ARE responses
        here, counted under their status."""
        route = request.route or "__unmatched__"
        method = request.method
        self.endpoints.begin(route, method)
        t0 = time.perf_counter()
        status = 500
        try:
            response = handler(request)
            status = response.status
            # server-side phase walls: "server" is this response's total
            # service wall; commits add apply / fsync via
            # request["phase_walls"] (_commit)
            walls = dict(request.get("phase_walls") or {})
            walls["server"] = time.perf_counter() - t0
            response.headers[distributed.HOP_WALLS_HEADER] = \
                distributed.encode_hop_walls(walls)
            return response
        except HTTPException as e:
            status = e.status
            raise
        finally:
            self.endpoints.done(route, method, status,
                                time.perf_counter() - t0)

    def _auth_middleware(self, request: Request, handler):
        # pluggable authenticator stack (components.clj:267-284: spnego /
        # basic / dev one-user, with impersonation wrapping the winner)
        authenticator = self.authenticator
        user = authenticator.authenticate(request)
        if user is None:
            if self._auth_exempt(request):
                # machine endpoints that carry no user credentials: LB
                # health probes and the executor's heartbeat/progress
                # posts (the reference receives these over the backend
                # channel, outside the authed REST stack)
                user = "anonymous"
            else:
                response = _err(401, "authentication required")
                for key, value in authenticator.challenge().items():
                    response.headers[key] = value
                self._apply_cors(request, response)
                return response
        impersonate = request.headers.get("X-Cook-Impersonate")
        if impersonate:
            if user not in self.config.admins:
                return _err(403, f"user {user} may not impersonate")
            user = impersonate
        request["user"] = user
        try:
            response = handler(request)
        except HTTPException as e:
            # HTTPExceptions ARE responses: CORS applies to errors too, or
            # browser JS can't read them and caches can cross-serve them
            self._apply_cors(request, e)
            raise
        except TransactionVetoed as e:
            response = _err(400, str(e))
        except MisroutedKey as e:
            # multi-process runtime (cook_tpu/mp/): this worker does not
            # own the key's shard — a stale front-end route map or a
            # client reading an old shard map.  421 (not 4xx-the-key):
            # the entity may well exist, just not HERE; the caller
            # refreshes its map (GET /debug/shards) and retries.
            response = _err(421, str(e))
            response.headers["X-Cook-Owner-Shard"] = str(e.owner_shard)
        except json.JSONDecodeError as e:
            response = _err(400, f"malformed JSON body: {e}")
        self._apply_cors(request, response)
        return response

    # ------------------------------------------------------ replica reads
    # Heavy read endpoints a non-leader replica serves from its replayed
    # journal, each response advertising bounded staleness
    # (shard/replica.py has the full contract).
    REPLICA_READ_ROUTES = frozenset((
        "/jobs", "/jobs/{uuid}", "/rawscheduler", "/list", "/running",
        "/unscheduled_jobs", "/stats/instances", "/instances",
        "/instances/{uuid}", "/group", "/usage",
    ))

    def _replica_evaluation(self) -> Optional[dict]:
        """The per-shard staleness decision, or None when this node is
        the leader / has no follower wired."""
        if self.leader or not self.config.replica_reads \
                or self.staleness_fn is None:
            return None
        from cook_tpu_torch.shard.replica import evaluate_staleness

        return evaluate_staleness(
            self.staleness_fn(),
            ceiling_ms=self.config.replica_staleness_ceiling_ms,
            refuse_after_s=self.config.replica_refuse_after_s)

    def _replica_middleware(self, request: Request, handler):
        """Replica-read gate + staleness stamping.  Leader (or
        follower-less) nodes pass straight through.  On a replica:
        refusal (stopped applying) and leader fallback (over the
        freshness ceiling) short-circuit heavy reads; served reads —
        including /debug/* — carry X-Cook-Staleness-Ms (worst shard) and
        X-Cook-Shard-Staleness (per-shard split), and JSON-object bodies
        gain a staleness_ms field."""
        verdict = self._replica_evaluation()
        if verdict is None or request.method != "GET":
            return handler(request)
        route = request.route or ""
        gated = route in self.REPLICA_READ_ROUTES
        if gated and verdict["action"] == "refuse":
            self._replica_refusals.inc()
            return _err(503, "replica stopped applying the leader's "
                             "journal; refusing stale reads "
                             "(X-Cook-Staleness-Ms unbounded)")
        if gated and verdict["action"] == "fallback":
            if self.leader_url:
                self._replica_fallbacks.inc()
                raise HTTPTemporaryRedirect(
                    f"{self.leader_url}{request.path_qs}")
            if verdict["staleness_ms"] == float("inf"):
                # never-synced AND no leader to redirect to: nothing
                # safe to serve
                self._replica_refusals.inc()
                return _err(503, "replica has not caught up with any "
                                 "leader yet and no leader is known")
        response = handler(request)
        if gated or route.startswith("/debug"):
            self._stamp_staleness(response, verdict)
        return response

    @staticmethod
    def _stamp_staleness(response, verdict: dict) -> None:
        worst = verdict["staleness_ms"]
        worst_txt = "inf" if worst == float("inf") else str(int(worst))
        response.headers["X-Cook-Staleness-Ms"] = worst_txt
        response.headers["X-Cook-Shard-Staleness"] = json.dumps({
            str(shard): ("inf" if ms == float("inf") else int(ms))
            for shard, ms in verdict["shards"].items()})
        if response.content_type == "application/json" and response.body:
            try:
                payload = json.loads(response.body)
            except ValueError:
                return
            if isinstance(payload, dict):
                payload["staleness_ms"] = (
                    None if worst == float("inf") else worst)
                response.body = json.dumps(payload).encode()

    def get_debug_replica(self, request: Request) -> Response:
        """Replica-read surface: whether this node serves replica reads,
        the per-shard staleness/stall view, and the decision the gate
        would take right now (serve / fallback / refuse)."""
        verdict = self._replica_evaluation()
        view = self.staleness_fn() if self.staleness_fn is not None else {}

        def clean(row):
            return {k: (None if v == float("inf") else v)
                    for k, v in row.items()}
        return json_response({
            "leader": self.leader,
            "replica_reads": self.config.replica_reads,
            "ceiling_ms": self.config.replica_staleness_ceiling_ms,
            "refuse_after_s": self.config.replica_refuse_after_s,
            "shards": {str(s): clean(row)
                       for s, row in sorted(view.items())},
            "decision": (None if verdict is None else {
                "action": verdict["action"],
                "staleness_ms": (None if verdict["staleness_ms"]
                                 == float("inf")
                                 else verdict["staleness_ms"]),
            }),
        })

    def _auth_exempt(self, request: Request) -> bool:
        path = request.path
        if path in ("/debug", "/debug/health"):
            # probe endpoints: LB liveness and the telemetry verdict both
            # get scraped by unauthenticated monitors
            return True
        if request.method == "GET" and path == "/metrics":
            return True
        if request.method == "POST" and (path.startswith("/heartbeat/")
                                         or path.startswith("/progress/")):
            token = self.config.executor_token
            if not token:
                return True
            # constant-time: this is the one credential that bypasses
            # strict auth; == would leak a byte-at-a-time timing oracle
            import hmac

            presented = request.headers.get("X-Cook-Executor-Token", "")
            return hmac.compare_digest(presented, token)
        return False

    def _apply_cors(self, request: Request, response) -> None:
        """CORS for browser dashboards, allowlist-gated (rest/cors.clj).
        Vary: Origin on EVERY response (success or error): the CORS
        headers differ per Origin, so shared caches must not serve one
        origin's copy (or a no-Origin copy with no CORS headers) to
        another."""
        response.headers.setdefault("Vary", "Origin")
        origin = request.headers.get("Origin")
        if origin and self._origin_allowed(origin):
            response.headers["Access-Control-Allow-Origin"] = origin
            response.headers["Access-Control-Allow-Credentials"] = "true"

    def _origin_allowed(self, origin: str) -> bool:
        for allowed in self.config.cors_origins:
            if allowed.startswith("re:"):
                try:
                    if re.fullmatch(allowed[3:], origin):
                        return True
                except re.error:
                    continue  # invalid pattern never matches (nor 500s)
            elif origin == allowed:
                return True
        return False

    # ------------------------------------------------------- txn commit seam

    def _run_commit(self, op: str, payload: dict,
                    txn_id: Optional[str]) -> TxnOutcome:
        """Run the (synchronous) commit pipeline with the loop released:
        it ends in an fsync (+ possible retry backoff sleeps), which must
        not stall other requests — the reference awaits it in the default
        executor — and commits running side by side let the journal's
        group-commit sync() merge them into one disk barrier."""
        with self.loop.released():
            return self.txn.commit(op, payload, txn_id=txn_id)

    def _commit(self, request: Request, op: str, payload: dict,
                *, txn_suffix: str = "") -> TxnOutcome:
        """Commit one mutation through the transaction pipeline (journaled
        and fsynced before the call returns when a journal is wired) and,
        in sync-ack mode, await the replication durability bound (the
        datomic.clj:79 durable-on-ack semantics, for EVERY mutation
        type).  Clients may pass X-Cook-Txn-Id: a retried request with
        the same id is answered from the transaction table, not
        re-applied — on this leader or a promoted standby."""
        from cook_tpu_torch.utils import tracing

        txn_id = request.headers.get("X-Cook-Txn-Id") or None
        if txn_id and txn_suffix:
            txn_id = f"{txn_id}:{txn_suffix}"
        t0 = time.perf_counter()
        outcome = self._run_commit(op, payload, txn_id)
        outcome.replicated = True
        walls = dict(outcome.phase_walls or {})
        if self.config.replication_sync_ack and not outcome.duplicate:
            t_repl = time.perf_counter()
            outcome.replicated = self._await_replication_outcome(
                outcome, walls)
            walls["replication_ack"] = time.perf_counter() - t_repl
            if not outcome.replicated:
                self._note_ack_timeout()
        if walls:
            # picked up by _endpoint_middleware into X-Cook-Hop-Walls
            outcome.phase_walls = walls
            request["phase_walls"] = walls
        # the server-side commit span, parented under the caller's span
        # when the request carried X-Cook-Parent-Span (the mp front end's
        # forward span)
        span_tags = {"op": op}
        if self.process_label:
            span_tags["process"] = self.process_label
        tracing.record_span(
            "rest.commit", time.perf_counter() - t0,
            parent=request.headers.get(distributed.PARENT_SPAN_HEADER),
            txn_id=outcome.txn_id, **span_tags)
        return outcome

    @staticmethod
    def _no_content(outcome: TxnOutcome) -> Response:
        """204 for a committed mutation; an unmet replication bound is
        flagged in a header (a 204 carries no body to say it in)."""
        response = Response(status=204)
        if outcome.replicated is False:
            response.headers["X-Cook-Replicated"] = "false"
        return response

    # ------------------------------------------------------------------ jobs

    def post_jobs(self, request: Request) -> Response:
        user = request["user"]
        # a RETRIED submission (same X-Cook-Txn-Id) must be answered
        # from the transaction table before parsing: the first commit's
        # jobs exist now, so re-parsing would 400 "already exists" on
        # exactly the requests idempotency is for
        txn_id = request.headers.get("X-Cook-Txn-Id")
        if txn_id:
            cached = self.store.txn_results.get(txn_id)
            if cached is not None and cached.get("op") == "jobs/submit":
                return json_response(dict(cached.get("result") or {}),
                                     status=201)
        body = request.json()
        specs = body.get("jobs", [])
        group_specs = body.get("groups", [])
        if not specs:
            return _err(400, "no jobs to schedule")
        if not self.submission_limiter.try_spend(user, len(specs)):
            return _err(429, "job submission rate limit exceeded")

        jobs, groups, parse_err = self.parse_submission(specs, group_specs,
                                                        user)
        if parse_err:
            return _err(400, parse_err)
        t_commit = time.perf_counter()
        try:
            outcome = self._commit(
                request, "jobs/submit",
                {"jobs": jobs, "groups": list(groups.values())})
        except TransactionVetoed as e:
            return _err(400, str(e))
        if not outcome.duplicate:
            # submit -> commit-ack SLO: apply + journal fsync + (sync-ack
            # mode) replication wait, as the submitting client experiences
            # it.  Idempotent replays answer from the txn table in ~0s and
            # would flood the histogram with samples no durable commit saw.
            from cook_tpu_torch.scheduler.monitor import observe_commit_ack

            commit_ack_s = time.perf_counter() - t_commit
            observe_commit_ack(commit_ack_s)
            # the same sample, windowed: the contention observatory's
            # SLO burn-rate evaluation (commit-ack-slo-burn)
            self.contention.commit_ack.observe(commit_ack_s)
            global_registry.counter(
                "jobs_submitted", "jobs accepted via POST /jobs").inc(
                len(jobs))
        body = dict(outcome.result or {"jobs": [j.uuid for j in jobs]})
        if outcome.replicated is False:
            # durable-on-ack (datomic.clj:79): the commit stands, but the
            # standby durability bound was not met — say so
            body["replicated"] = False
        return json_response(body, status=201)

    def parse_submission(
            self, specs: list, group_specs: list, user: str,
    ) -> tuple[list, dict, Optional[str]]:
        """Parse + validate one submit batch into entity objects:
        group parsing, pool selection/acceptance, submission plugins,
        job parsing/adjustment, and the per-pool queue-limit check.
        Returns (jobs, groups, error) with error None on success — the
        shared seam under POST /jobs and the mp runtime's 2PC prepare
        phase (cook_tpu/mp/worker.py), which must veto with EXACTLY the
        conditions a single-process submit would 400 on.  Rate limiting
        and idempotency stay with the caller (they are per-entry-point,
        not per-validation)."""
        groups: dict[str, Group] = {}
        for gs in group_specs:
            group, err = self._parse_group(gs)
            if err:
                return [], {}, err
            groups[group.uuid] = group
        jobs = []
        pools_counted: dict[str, int] = {}
        for spec in specs:
            pool = self.plugins.pool_selector.select_pool(
                spec, self.config.default_pool
            )
            pool_ent = self.store.pools.get(pool)
            if pool_ent is None or not pool_ent.accepts_submissions:
                return [], {}, f"pool {pool} does not accept submissions"
            result = self.plugins.validate_submission(spec, user, pool)
            if not result.accepted:
                return [], {}, result.message or "rejected by plugin"
            spec = self.plugins.modify_submission(spec, user, pool)
            try:
                job, err = self._parse_job(spec, user, pool, groups)
            except (ValueError, TypeError) as e:
                # non-numeric mem/cpus/disk/ports etc.: a client error,
                # not a server fault
                job, err = None, f"malformed job field: {e}"
            if err:
                return [], {}, err
            # JobAdjusters (plugins/definitions.clj JobAdjuster, e.g. the
            # pool mover) may rewrite the parsed job; an adjusted pool
            # must still exist and accept work, else revert ONLY the pool
            # (other adjusters' changes survive)
            adjusted = self.plugins.adjust(job)
            if adjusted.pool != job.pool:
                dest = self.store.pools.get(adjusted.pool)
                if dest is None or not dest.accepts_submissions:
                    adjusted = adjusted.with_(pool=job.pool)
            job = adjusted
            jobs.append(job)
            pools_counted[job.pool] = pools_counted.get(job.pool, 0) + 1
        # gang batches must be complete (store._validate_gangs re-checks
        # under the txn lock; this mirrors it so the mp 2PC prepare phase
        # vetoes with the same message a single-process 400 carries)
        gangs: dict[str, list[Job]] = {}
        for job in jobs:
            if job.gang_size > 0 and job.group_uuid:
                gangs.setdefault(job.group_uuid, []).append(job)
        for guuid, members in gangs.items():
            k = members[0].gang_size
            if any(j.gang_size != k for j in members):
                return [], {}, f"group {guuid}: members disagree on gang_size"
            if any(j.pool != members[0].pool for j in members):
                return [], {}, f"group {guuid}: gang members span pools"
            if len(members) != k:
                return [], {}, (
                    f"group {guuid}: gang_size {k} but {len(members)} "
                    "member(s) in the batch (gangs submit atomically)")
        for pool, count in pools_counted.items():
            limit_err = self.queue_limits.check_submission(user, pool, count)
            if limit_err:
                return [], {}, limit_err
        return jobs, groups, None

    def _parse_job(self, spec: dict, user: str, pool: str,
                   groups: dict[str, Group]) -> tuple[Optional[Job], Optional[str]]:
        uuid = spec.get("uuid") or new_uuid()
        if uuid in self.store.jobs:
            return None, f"job {uuid} already exists"
        command = spec.get("command", "")
        if not command:
            return None, "command is required"
        mem = float(spec.get("mem", 128.0))
        cpus = float(spec.get("cpus", 1.0))
        gpus = float(spec.get("gpus", 0.0))
        if mem <= 0 or mem > self.config.max_job_mem:
            return None, f"mem {mem} out of range (0, {self.config.max_job_mem}]"
        if cpus <= 0 or cpus > self.config.max_job_cpus:
            return None, f"cpus {cpus} out of range (0, {self.config.max_job_cpus}]"
        if gpus < 0 or gpus > self.config.max_job_gpus:
            return None, f"gpus {gpus} out of range [0, {self.config.max_job_gpus}]"
        # disk: a bare number, or {"request": MiB, "type": "pd-ssd"}
        # (disk-host-constraint, constraints.clj:164)
        disk_spec = spec.get("disk", 0.0)
        if isinstance(disk_spec, dict):
            disk = float(disk_spec.get("request", 0.0))
            disk_type = str(disk_spec.get("type", ""))
        else:
            disk = float(disk_spec)
            disk_type = ""
        ports = int(spec.get("ports", 0))
        if not 0 <= ports <= 1000:
            return None, f"ports {ports} out of range [0, 1000]"
        max_retries = int(spec.get("max_retries", 1))
        if not 0 < max_retries <= self.config.max_retries_limit:
            return None, f"max_retries {max_retries} out of range"
        priority = int(spec.get("priority", 50))
        if not 0 <= priority <= 100:
            return None, f"priority {priority} out of range [0, 100]"
        constraints = []
        for c in spec.get("constraints", []):
            # ["attribute", "EQUALS", "pattern"]
            if len(c) != 3 or str(c[1]).upper() != "EQUALS":
                return None, f"unsupported constraint {c}"
            constraints.append(
                JobConstraint(attribute=c[0],
                              operator=ConstraintOperator.EQUALS,
                              pattern=c[2])
            )
        gang_size = int(spec.get("gang_size", 0))
        if gang_size < 0 or gang_size == 1 \
                or gang_size > self.config.max_gang_size:
            return None, (f"gang_size {gang_size} out of range "
                          f"(0 or [2, {self.config.max_gang_size}])")
        group_uuid = spec.get("group")
        if gang_size and not group_uuid:
            return None, "gang_size requires a group"
        if group_uuid and group_uuid not in groups \
                and group_uuid not in self.store.groups:
            # implicit group creation (reference: make-default-host-placement)
            groups[group_uuid] = Group(uuid=group_uuid)
        if gang_size and group_uuid in groups:
            # gang members need k DISTINCT hosts: an implicit (or
            # placement-less) gang group is promoted to unique-host so
            # validate_group_assignments enforces distinctness
            g = groups[group_uuid]
            if g.host_placement.type == GroupPlacementType.ALL:
                groups[group_uuid] = dataclasses.replace(
                    g, host_placement=HostPlacement(
                        type=GroupPlacementType.UNIQUE))
        container = None
        cspec = spec.get("container")
        if cspec:
            docker = cspec.get("docker", cspec)
            container = Container(
                image=docker.get("image", ""),
                kind=cspec.get("type", "docker").lower(),
                env=tuple(sorted(docker.get("env", {}).items())),
            )
        application = None
        aspec = spec.get("application")
        if aspec:
            application = Application(
                name=aspec.get("name", ""),
                version=aspec.get("version", ""),
                workload_class=aspec.get("workload-class", ""),
                workload_id=aspec.get("workload-id", ""),
            )
        checkpoint = None
        ckpt = spec.get("checkpoint")
        if ckpt:
            checkpoint = Checkpoint(
                mode=ckpt.get("mode", "auto"),
                periodic_sec=int(ckpt.get("periodic-sec", 0)),
                preserve_paths=tuple(ckpt.get("preserve-paths", ())),
                location=ckpt.get("location", ""),
            )
        job = Job(
            uuid=uuid,
            user=user,
            command=command,
            name=spec.get("name", "cookjob"),
            priority=priority,
            max_retries=max_retries,
            max_runtime_ms=int(spec.get("max_runtime", 2**62)),
            expected_runtime_ms=int(spec.get("expected_runtime", 0)),
            resources=Resources(mem=mem, cpus=cpus, gpus=gpus,
                                disk=disk, disk_type=disk_type,
                                ports=ports),
            pool=pool,
            user_provided_env=tuple(sorted(spec.get("env", {}).items())),
            labels=tuple(sorted(spec.get("labels", {}).items())),
            constraints=tuple(constraints),
            group_uuid=group_uuid,
            gang_size=gang_size,
            container=container,
            application=application,
            checkpoint=checkpoint,
            disable_mea_culpa_retries=bool(
                spec.get("disable_mea_culpa_retries", False)),
        )
        return job, None

    def _parse_group(self, spec: dict) -> tuple[Optional[Group], Optional[str]]:
        uuid = spec.get("uuid") or new_uuid()
        hp = spec.get("host_placement", {"type": "all"})
        try:
            ptype = GroupPlacementType(hp.get("type", "all"))
        except ValueError:
            return None, f"unknown host placement type {hp.get('type')}"
        sh = spec.get("straggler_handling", {"type": "none"})
        params = sh.get("parameters", {})
        return (
            Group(
                uuid=uuid,
                name=spec.get("name", "defaultgroup"),
                host_placement=HostPlacement(
                    type=ptype,
                    attribute=hp.get("parameters", {}).get("attribute", ""),
                    minimum=int(hp.get("parameters", {}).get("minimum", 0)),
                ),
                straggler_handling=StragglerHandling(
                    type=sh.get("type", "none"),
                    quantile=float(params.get("quantile", 0.5)),
                    multiplier=float(params.get("multiplier", 2.0)),
                ),
            ),
            None,
        )

    def get_jobs(self, request: Request) -> Response:
        shed = self._shed("/jobs")
        if shed is not None:
            return shed
        uuids = request.query.getall("job", []) + request.query.getall("uuid", [])
        # resolve instance uuids to their jobs (reference: rawscheduler
        # accepts instance ids too)
        for inst_uuid in request.query.getall("instance", []):
            inst = self.store.instances.get(inst_uuid)
            if inst is None:
                return _err(404, f"unknown instance {inst_uuid}")
            uuids.append(inst.job_uuid)
        user = request.query.get("user")
        states = set(
            s for q in request.query.getall("state", []) for s in q.split("+")
        )
        out = []
        if uuids:
            for uuid in uuids:
                job = self.store.jobs.get(uuid)
                if job is None:
                    return _err(404, f"unknown job {uuid}")
                out.append(self._job_json(job))
        elif user:
            start = int(request.query.get("start-ms", 0))
            end = int(request.query.get("end-ms", 2**62))
            for job in self.store.user_jobs(user):
                if states and job.state.value not in states:
                    continue
                if not (start <= job.submit_time_ms <= end):
                    continue
                out.append(self._job_json(job))
        else:
            return _err(400, "specify job uuids or a user")
        return json_response(out)

    def get_job(self, request: Request) -> Response:
        job = self.store.jobs.get(request.match_info["uuid"])
        if job is None:
            return _err(404, "unknown job")
        return json_response(self._job_json(job))

    def _job_json(self, job: Job) -> dict:
        d = job_display(job)
        d["instances"] = [
            self._instance_json(i) for i in self.store.job_instances(job.uuid)
        ]
        d["retries_remaining"] = max(
            0, job.max_retries - attempts_consumed(
                job, self.store.job_instances(job.uuid)))
        if job.group_uuid:
            d["groups"] = [job.group_uuid]
        return d

    def _instance_json(self, inst: Instance) -> dict:
        d = {
            "task_id": inst.task_id,
            "slave_id": inst.node_id,
            "hostname": inst.hostname,
            "status": inst.status.value,
            "preempted": inst.preempted,
            "backfilled": inst.backfilled,
            "compute-cluster": inst.compute_cluster,
            "start_time": inst.start_time_ms,
            "progress": inst.progress,
        }
        if inst.end_time_ms:
            d["end_time"] = inst.end_time_ms
        if inst.reason_code is not None:
            reason = REASONS_BY_CODE.get(inst.reason_code)
            d["reason_code"] = inst.reason_code
            if reason:
                d["reason_string"] = reason.description
                d["reason_mea_culpa"] = reason.mea_culpa
        if inst.exit_code is not None:
            d["exit_code"] = inst.exit_code
        if inst.sandbox_directory:
            d["sandbox_directory"] = inst.sandbox_directory
        if inst.progress_message:
            d["progress_message"] = inst.progress_message
        if self.scheduler is not None:
            cluster = self.scheduler.cluster_by_name(inst.compute_cluster)
            if cluster is not None:
                # FileUrlGenerator seam (plugins/definitions.clj:56):
                # deployments may front sandbox access with their own
                # file service instead of the backend's sidecar URL
                url = self.plugins.sandbox_url(
                    inst,
                    lambda: cluster.retrieve_sandbox_url_path(inst.task_id),
                )
                if url:
                    d["output_url"] = url
        return d

    def delete_jobs(self, request: Request) -> Response:
        uuids = request.query.getall("job", []) + request.query.getall("uuid", [])
        if not uuids:
            return _err(400, "no jobs specified")
        user = request["user"]
        for uuid in uuids:
            job = self.store.jobs.get(uuid)
            if job is None:
                return _err(404, f"unknown job {uuid}")
            if job.user != user and user not in self.config.admins:
                return _err(403, f"not authorized to kill {uuid}")
        outcome = self._commit(request, "jobs/kill", {"uuids": uuids})
        if not outcome.duplicate:
            global_registry.counter(
                "jobs_killed", "jobs killed via DELETE /jobs").inc(
                len(uuids))
        return self._no_content(outcome)

    # ------------------------------------------------------------- instances

    def get_instance(self, request: Request) -> Response:
        inst = self.store.instances.get(request.match_info["uuid"])
        if inst is None:
            return _err(404, "unknown instance")
        d = self._instance_json(inst)
        d["job"] = self._job_json(self.store.jobs[inst.job_uuid])
        return json_response(d)

    def get_instances(self, request: Request) -> Response:
        uuids = request.query.getall("instance", [])
        out = []
        for uuid in uuids:
            inst = self.store.instances.get(uuid)
            if inst is None:
                return _err(404, f"unknown instance {uuid}")
            out.append(self._instance_json(inst))
        return json_response(out)

    def delete_instances(self, request: Request) -> Response:
        """Cancel specific instances (the job may retry elsewhere); the
        cancelled-task-killer reaps them (scheduler.clj:2000)."""
        uuids = request.query.getall("instance", [])
        user = request["user"]
        for uuid in uuids:
            inst = self.store.instances.get(uuid)
            if inst is None:
                return _err(404, f"unknown instance {uuid}")
            job = self.store.jobs[inst.job_uuid]
            if job.user != user and user not in self.config.admins:
                return _err(403, f"not authorized to cancel {uuid}")
        outcome = self._commit(request, "instance/cancel",
                               {"task_ids": uuids})
        if self.scheduler is not None:
            self.scheduler.kill_cancelled_tasks()
        return self._no_content(outcome)

    # ---------------------------------------------------------------- groups

    def get_groups(self, request: Request) -> Response:
        uuids = request.query.getall("uuid", [])
        detailed = request.query.get("detailed") in ("true", "1")
        out = []
        for uuid in uuids:
            group = self.store.groups.get(uuid)
            if group is None:
                return _err(404, f"unknown group {uuid}")
            d = {
                "uuid": group.uuid,
                "name": group.name,
                "host_placement": {
                    "type": group.host_placement.type.value,
                    "parameters": (
                        {"attribute": group.host_placement.attribute}
                        if group.host_placement.attribute else {}
                    ),
                },
                "jobs": list(group.job_uuids),
            }
            if detailed:
                by_state: dict[str, int] = {}
                for ju in group.job_uuids:
                    job = self.store.jobs.get(ju)
                    if job:
                        by_state[job.state.value] = by_state.get(
                            job.state.value, 0) + 1
                d["composition"] = by_state
            out.append(d)
        return json_response(out)

    def delete_groups(self, request: Request) -> Response:
        uuids = request.query.getall("uuid", [])
        for uuid in uuids:
            if uuid not in self.store.groups:
                return _err(404, f"unknown group {uuid}")
        outcome = self._commit(request, "group/kill", {"groups": uuids})
        return self._no_content(outcome)

    # ------------------------------------------------------------ share/quota

    def get_share(self, request: Request) -> Response:
        user = request.query.get("user")
        pool = request.query.get("pool", self.config.default_pool)
        if not user:
            return _err(400, "user required")
        share = self.store.get_share(user, pool)
        return json_response(_res_json(share))

    def post_share(self, request: Request) -> Response:
        if request["user"] not in self.config.admins:
            return _err(403, "only admins may modify shares")
        body = request.json()
        user = body.get("user")
        pool = body.get("pool", self.config.default_pool)
        res = body.get("share", {})
        if not user:
            return _err(400, "user required")
        outcome = self._commit(request, "share/set", {"share": Share(
            user=user, pool=pool,
            resources=Resources(
                mem=float(res.get("mem", 0)),
                cpus=float(res.get("cpus", 0)),
                gpus=float(res.get("gpus", 0)),
            ),
            reason=body.get("reason", ""),
        )})
        body_out = _res_json(self.store.get_share(user, pool))
        if outcome.replicated is False:
            body_out["replicated"] = False
        return json_response(body_out, status=201)

    def delete_share(self, request: Request) -> Response:
        if request["user"] not in self.config.admins:
            return _err(403, "only admins may modify shares")
        user = request.query.get("user")
        pool = request.query.get("pool", self.config.default_pool)
        outcome = self._commit(request, "share/retract",
                               {"user": user, "pool": pool})
        return self._no_content(outcome)

    def get_quota(self, request: Request) -> Response:
        user = request.query.get("user")
        pool = request.query.get("pool", self.config.default_pool)
        if not user:
            return _err(400, "user required")
        quota = self.store.get_quota(user, pool)
        d = _res_json(quota.resources)
        d["count"] = quota.count
        return json_response(d)

    def post_quota(self, request: Request) -> Response:
        if request["user"] not in self.config.admins:
            return _err(403, "only admins may modify quotas")
        body = request.json()
        user = body.get("user")
        pool = body.get("pool", self.config.default_pool)
        res = body.get("quota", {})
        if not user:
            return _err(400, "user required")
        inf = float("inf")
        outcome = self._commit(request, "quota/set", {"quota": Quota(
            user=user, pool=pool,
            resources=Resources(
                mem=float(res.get("mem", inf)),
                cpus=float(res.get("cpus", inf)),
                gpus=float(res.get("gpus", inf)),
            ),
            count=int(res.get("count", 2**31)),
            reason=body.get("reason", ""),
        )})
        body_out = {"user": user, "pool": pool}
        if outcome.replicated is False:
            body_out["replicated"] = False
        return json_response(body_out, status=201)

    def delete_quota(self, request: Request) -> Response:
        if request["user"] not in self.config.admins:
            return _err(403, "only admins may modify quotas")
        user = request.query.get("user")
        pool = request.query.get("pool", self.config.default_pool)
        outcome = self._commit(request, "quota/retract",
                               {"user": user, "pool": pool})
        return self._no_content(outcome)

    def get_usage(self, request: Request) -> Response:
        user = request.query.get("user")
        if not user:
            return _err(400, "user required")
        out = {"total_usage": {"mem": 0.0, "cpus": 0.0, "gpus": 0.0, "jobs": 0}}
        pools = {}
        for pool_name in self.store.pools:
            usage = self.store.user_usage(pool_name).get(user)
            running = [
                j for j in self.store.running_jobs(pool_name) if j.user == user
            ]
            if usage is None and not running:
                continue
            usage = usage or Resources()
            pools[pool_name] = {
                "usage": {"mem": usage.mem, "cpus": usage.cpus,
                          "gpus": usage.gpus, "jobs": len(running)},
            }
            out["total_usage"]["mem"] += usage.mem
            out["total_usage"]["cpus"] += usage.cpus
            out["total_usage"]["gpus"] += usage.gpus
            out["total_usage"]["jobs"] += len(running)
        out["pools"] = pools
        return json_response(out)

    # ----------------------------------------------------------------- retry

    def get_retry(self, request: Request) -> Response:
        uuid = request.query.get("job")
        job = self.store.jobs.get(uuid or "")
        if job is None:
            return _err(404, "unknown job")
        return json_response(job.max_retries)

    def post_retry(self, request: Request) -> Response:
        body = request.json()
        uuids = body.get("jobs") or ([body["job"]] if "job" in body else [])
        if not uuids:
            return _err(400, "no jobs specified")
        retries = body.get("retries")
        increment = body.get("increment")
        if retries is None and increment is None:
            return _err(400, "retries or increment required")
        txn_id = request.headers.get("X-Cook-Txn-Id") or None
        last_seqs: dict[int, int] = {}
        fresh = 0
        for uuid in uuids:
            if uuid not in self.store.jobs:
                return _err(404, f"unknown job {uuid}")
            try:
                # one transaction per job (each is one atomic retry
                # commit); a client txn id fans out per-job so retried
                # batches dedupe jobwise.  An absolute `retries` wins
                # over `increment` when both are present (the original
                # precedence).
                outcome = self._run_commit(
                    "job/retry",
                    {"uuid": uuid,
                     "retries": int(retries if retries is not None
                                    else increment),
                     "increment": retries is None},
                    txn_id=f"{txn_id}:{uuid}" if txn_id else None)
            except (TransactionVetoed, ValueError) as e:
                return _err(400, str(e))
            fresh += self._merge_batch_seqs(last_seqs, outcome)
        body_out = {"jobs": uuids}
        if not self._batch_replicated(last_seqs, fresh):
            body_out["replicated"] = False
        return json_response(body_out, status=201)

    @staticmethod
    def _merge_batch_seqs(last_seqs: dict[int, int],
                          outcome: TxnOutcome) -> int:
        """Fold one per-item commit of a batch into the batch's highest
        seq per shard; 1 when it was a fresh commit, 0 for an idempotent
        replay (duplicates met their bound when first acked: merging
        their seqs would make the batch wait on replication that already
        happened)."""
        if outcome.duplicate:
            return 0
        for shard, seq in (outcome.shard_seqs or {0: outcome.seq}).items():
            last_seqs[shard] = max(last_seqs.get(shard, 0), seq)
        return 1

    def _batch_replicated(self, last_seqs: dict[int, int],
                          fresh: int) -> bool:
        """The sync-ack wait of a batch of per-item commits: one wait per
        touched shard covers the whole batch (acks are cumulative
        sequence numbers per shard)."""
        if not self.config.replication_sync_ack or not fresh:
            return True
        for shard, seq in sorted(last_seqs.items()):
            if not self._await_replication(seq, shard):
                self._note_ack_timeout()
                return False
        return True

    # ------------------------------------------------------------- pool move

    def post_pool_move(self, request: Request) -> Response:
        """Move WAITING jobs to another pool (the reference's pool mover,
        plugins/pool_mover.clj, as an admin mutation instead of a
        submission-time adjuster)."""
        if request["user"] not in self.config.admins:
            return _err(403, "only admins may move jobs between pools")
        body = request.json()
        uuids = body.get("jobs") or ([body["job"]] if "job" in body else [])
        pool = body.get("pool")
        if not uuids or not pool:
            return _err(400, "jobs and pool required")
        if pool not in self.store.pools:
            return _err(400, f"unknown pool {pool}")
        for uuid in uuids:
            if uuid not in self.store.jobs:
                return _err(404, f"unknown job {uuid}")
        txn_id = request.headers.get("X-Cook-Txn-Id") or None
        moved, skipped = [], []
        last_seqs: dict[int, int] = {}
        fresh = 0
        for uuid in uuids:
            outcome = self._run_commit(
                "job/pool-move", {"uuid": uuid, "pool": pool},
                f"{txn_id}:{uuid}" if txn_id else None)
            result = outcome.result or {}
            (moved if result.get("moved") else skipped).append(uuid)
            fresh += self._merge_batch_seqs(last_seqs, outcome)
        body_out = {"moved": moved, "skipped": skipped, "pool": pool}
        if not self._batch_replicated(last_seqs, fresh):
            body_out["replicated"] = False
        return json_response(body_out, status=201)

    # ------------------------------------------------------------- queue etc

    def get_queue(self, request: Request) -> Response:
        shed = self._shed("/queue")
        if shed is not None:
            return shed
        if not self.leader and self.leader_url:
            # non-leader nodes send queue queries to the leader
            # (reference: leader proxying, rest/api.clj:2408)
            raise HTTPTemporaryRedirect(
                f"{self.leader_url}/queue"
            )
        if self.scheduler is None:
            return _err(503, "no scheduler attached")
        out = {}
        for pool_name, queue in self.scheduler.pool_queues.items():
            out[pool_name] = [
                {"uuid": j.uuid, "user": j.user, "dru": queue.dru.get(j.uuid)}
                for j in queue.jobs[:100]
            ]
        return json_response(out)

    def get_running(self, request: Request) -> Response:
        shed = self._shed("/running")
        if shed is not None:
            return shed
        out = []
        for pool_name in self.store.pools:
            for job in self.store.running_jobs(pool_name):
                out.append(self._job_json(job))
        return json_response(out)

    def get_list(self, request: Request) -> Response:
        shed = self._shed("/list")
        if shed is not None:
            return shed
        user = request.query.get("user")
        if not user:
            return _err(400, "user required")
        states = set(
            s
            for q in request.query.getall("state", [])
            for s in q.replace("+", ",").split(",")
        )
        start = int(request.query.get("start-ms", 0))
        end = int(request.query.get("end-ms", 2**62))
        limit = int(request.query.get("limit", 1000))
        out = []
        for job in self.store.user_jobs(user):
            if states and job.state.value not in states:
                continue
            if not (start <= job.submit_time_ms <= end):
                continue
            out.append(self._job_json(job))
            if len(out) >= limit:
                break
        return json_response(out)

    def get_unscheduled(self, request: Request) -> Response:
        shed = self._shed("/unscheduled_jobs")
        if shed is not None:
            return shed
        from cook_tpu_torch.scheduler.monitor import starvation_stats

        uuids = request.query.getall("job", [])
        telemetry = self._telemetry()
        out = []
        for uuid in uuids:
            job = self.store.jobs.get(uuid)
            if job is None:
                return _err(404, f"unknown job {uuid}")
            entry = {
                "uuid": uuid,
                "reasons": self._unscheduled_reasons(job),
            }
            if job.state.value == "waiting":
                # starvation echo: how long THIS job has queued, against
                # its pool's oldest wait — so "why isn't it running" and
                # "is the whole pool starving" answer in one reply
                sv = starvation_stats(self.store, job.pool)
                start = (job.last_waiting_start_time_ms
                         or job.submit_time_ms)
                entry["starvation"] = {
                    "job_wait_s": max(
                        0.0, (self.store.clock() - start) / 1000.0),
                    "pool_oldest_wait_s": sv["oldest_age_s"],
                    "pool_worst_user": sv.get("worst_user", ""),
                }
            if telemetry is not None:
                # the pool's last device solve (padded problem shape,
                # backend, compile flag) so a reason code correlates
                # with compile behavior without a /debug/cycles join
                solve = telemetry.solve_info(job.pool)
                if solve is not None:
                    entry["pool_solve"] = solve
            out.append(entry)
        return json_response(out)

    def _unscheduled_reasons(self, job: Job) -> list[dict]:
        """Why isn't this job running (reference unscheduled.clj:172)."""
        reasons = []
        if job.state.value == "completed":
            return [{"reason": "The job is already completed."}]
        if job.state.value == "running":
            return [{"reason": "The job is running now."}]
        insts = self.store.job_instances(job.uuid)
        if all_attempts_consumed(job, insts):
            reasons.append({
                "reason": "The job has exhausted its maximum number of retries.",
            })
        quota = self.store.get_quota(job.user, job.pool)
        usage = self.store.user_usage(job.pool).get(job.user, Resources())
        if (usage.mem + job.resources.mem > quota.resources.mem
                or usage.cpus + job.resources.cpus > quota.resources.cpus):
            reasons.append({
                "reason": "The job would cause you to exceed resource quotas.",
            })
        if self.scheduler is not None:
            # the flight recorder's last-cycle decision beats the static
            # placement-failure text: it carries the machine-readable
            # reason code and the cycle id that produced it
            from cook_tpu_torch.scheduler import flight_recorder as fr

            recorder = self._recorder()
            cycle_reason = (recorder.job_reason(job.uuid)
                            if recorder is not None else None)
            if cycle_reason is not None and cycle_reason[1] != fr.MATCHED:
                # a "matched" entry for a job that is WAITING again means
                # the instance failed since — stale, fall through to the
                # placement-failure text instead of claiming a match
                cycle_id, code, detail = cycle_reason
                reasons.append({
                    "reason": "The job couldn't be placed on any available "
                              "hosts." if code != fr.NOT_CONSIDERED else
                              "The job was not considered in the last "
                              "match cycle.",
                    "data": {"reason_code": code, "cycle": cycle_id,
                             "reasons": ([{"reason": detail}]
                                         if detail else [])},
                })
            else:
                failure = self.scheduler.placement_failures.get(job.uuid)
                if failure:
                    reasons.append({
                        "reason": "The job couldn't be placed on any "
                                  "available hosts.",
                        "data": {"reasons": [{"reason": failure}]},
                    })
            queue = self.scheduler.pool_queues.get(job.pool)
            if queue is not None:
                for pos, qjob in enumerate(queue.jobs):
                    if qjob.uuid == job.uuid:
                        reasons.append({
                            "reason": "You have 1 other jobs ahead in the "
                                      "queue." if pos == 1 else
                                      f"You have {pos} other jobs ahead in "
                                      "the queue.",
                            "data": {"position": pos},
                        })
                        break
        return reasons or [{"reason": "The job is waiting to be matched."}]

    def get_instance_stats(self, request: Request) -> Response:
        """Aggregate instance stats (reference task_stats.clj)."""
        shed = self._shed("/stats/instances")
        if shed is not None:
            return shed
        start = int(request.query.get("start-ms", 0))
        end = int(request.query.get("end-ms", 2**62))
        durations = []
        by_status: dict[str, int] = {}
        by_reason: dict[str, int] = {}
        for inst in self.store.instances.values():
            if not inst.status.terminal:
                continue
            if not (start <= inst.end_time_ms <= end):
                continue
            by_status[inst.status.value] = by_status.get(inst.status.value, 0) + 1
            if inst.status.value == "failed":
                reason = REASONS_BY_CODE.get(inst.reason_code)
                key = reason.name if reason else "unknown"
                by_reason[key] = by_reason.get(key, 0) + 1
            durations.append(inst.end_time_ms - inst.start_time_ms)
        percentiles = {}
        if durations:
            qs = statistics.quantiles(durations, n=100) if len(durations) > 1 \
                else [durations[0]] * 99
            percentiles = {"50": qs[49], "75": qs[74], "95": qs[94],
                           "99": qs[98], "100": max(durations)}
        return json_response({
            "by-status": by_status,
            "by-reason": by_reason,
            "run-time-ms": {"percentiles": percentiles,
                            "count": len(durations)},
        })

    def get_pools(self, request: Request) -> Response:
        return json_response([
            {"name": p.name, "purpose": p.purpose, "state": p.state,
             "dru-mode": p.dru_mode.value}
            for p in self.store.pools.values()
        ])

    def get_settings(self, request: Request) -> Response:
        payload = {
            "default-pool": self.config.default_pool,
            "max-job-mem": self.config.max_job_mem,
            "max-job-cpus": self.config.max_job_cpus,
            "max-retries-limit": self.config.max_retries_limit,
            "version": self.config.version,
        }
        if self.scheduler is not None:
            # the EFFECTIVE matcher config (after tuned_match.json merge)
            # so operators can verify which kernel production runs
            from cook_tpu_torch.ops.match import vmap_safe_backend

            m = self.scheduler.config.match
            payload["matcher"] = {
                "backend": m.backend, "chunk": m.chunk,
                "rounds": m.chunk_rounds, "passes": m.chunk_passes,
                "kc": m.chunk_kc,
                # the pool-batched/pool-sharded paths coerce pallas->xla
                # (pallas_call under vmap); report what actually runs
                # there so a pallas rollout isn't misread as active
                "backend_batched": vmap_safe_backend(m.backend),
                "quality_audit_every": m.quality_audit_every,
            }
        return json_response(payload)

    def get_info(self, request: Request) -> Response:
        return json_response({
            "authentication-scheme": "http-basic",
            "commit": self.config.version,
            "start-time": 0,
            "version": self.config.version,
            "leader-url": "http://localhost",
        })

    def get_failure_reasons(self, request: Request) -> Response:
        return json_response([
            {"code": r.code, "name": r.name, "description": r.description,
             "mea_culpa": r.mea_culpa,
             **({"failure_limit": r.failure_limit}
                if r.failure_limit is not None else {})}
            for r in _REASONS
        ])

    # -------------------------------------------------------------- progress

    def get_progress(self, request: Request) -> Response:
        inst = self.store.instances.get(request.match_info["uuid"])
        if inst is None:
            return _err(404, "unknown instance")
        return json_response({
            "progress": inst.progress,
            "progress_message": inst.progress_message,
        })

    def post_progress(self, request: Request) -> Response:
        """Sidecar/executor progress feed (reference: progress.clj +
        rest/api.clj:3995)."""
        task_id = request.match_info["uuid"]
        body = request.json()
        ok = self.store.update_instance_progress(
            task_id,
            int(body.get("progress_percent", 0)),
            str(body.get("progress_message", "")),
        )
        if not ok and task_id not in self.store.instances:
            return _err(404, "unknown instance")
        return json_response({"accepted": ok}, status=202 if ok else 200)

    def post_heartbeat(self, request: Request) -> Response:
        """Executor liveness beat (reference: heartbeat framework messages,
        mesos/heartbeat.clj; here the executor POSTs over HTTP)."""
        task_id = request.match_info["uuid"]
        if task_id not in self.store.instances:
            return _err(404, "unknown instance")
        if self.scheduler is not None and \
                getattr(self.scheduler, "heartbeats", None) is not None:
            self.scheduler.heartbeats.notify(task_id)
        return json_response({"accepted": True}, status=202)

    # --------------------------------------------------------------- metrics

    def get_metrics(self, request: Request) -> Response:
        return Response(text=global_registry.render_prometheus(),
                        content_type="text/plain")

    # ------------------------------------------------- dynamic clusters etc.

    def get_compute_clusters(self, request: Request) -> Response:
        if self.scheduler is None:
            return json_response({"in-mem-configs": []})
        return json_response({
            "in-mem-configs": [
                {"name": c.name, "state": c.state.value,
                 "accepts-work": c.accepts_work}
                for c in self.scheduler.clusters
            ]
        })

    def post_compute_cluster(self, request: Request) -> Response:
        if request["user"] not in self.config.admins:
            return _err(403, "admin required")
        body = request.json()
        name = body.get("name")
        new_state = body.get("state")
        if self.scheduler is None:
            return _err(503, "no scheduler attached")
        cluster = self.scheduler.cluster_by_name(name)
        if cluster is None:
            if "kind" not in body:
                return _err(404, f"unknown cluster {name}")
            # dynamic cluster creation (compute-clusters CRUD,
            # rest/api.clj:3914 + compute_cluster.clj:450-530)
            from cook_tpu_torch.components import (
                CLUSTER_FACTORIES,
                start_cluster_backend,
            )

            factory = CLUSTER_FACTORIES.get(body["kind"])
            if factory is None:
                return _err(400, f"unknown cluster kind {body['kind']}")
            try:
                cluster = factory(body, self.store.clock)
                self.scheduler.add_cluster(cluster)
            except (ValueError, KeyError) as e:
                return _err(400, str(e))
            if self.leader and self.scheduler.active:
                # a k8s cluster's controller and watch (a standby's start
                # with its leadership)
                start_cluster_backend(cluster, self.store)
            return json_response(
                {"name": name, "state": cluster.state.value}, status=201)
        try:
            cluster.set_state(ClusterState(new_state))
        except ValueError as e:
            return _err(400, str(e))
        return json_response({"name": name, "state": new_state}, status=201)

    def delete_compute_cluster(self, request: Request) -> Response:
        if request["user"] not in self.config.admins:
            return _err(403, "admin required")
        name = request.match_info["name"]
        if self.scheduler is None:
            return _err(503, "no scheduler attached")
        cluster = self.scheduler.cluster_by_name(name)
        if cluster is None:
            return _err(404, f"unknown cluster {name}")
        try:
            cluster.set_state(ClusterState.DELETED)
        except ValueError as e:
            return _err(400, str(e))
        return Response(status=204)

    def get_incremental_config(self, request: Request) -> Response:
        return json_response(self.store.dynamic_config)

    def post_incremental_config(self, request: Request) -> Response:
        if request["user"] not in self.config.admins:
            return _err(403, "admin required")
        body = request.json()
        self._commit(request, "config/update", {"updates": body})
        return json_response(self.store.dynamic_config, status=201)

    def post_shutdown_leader(self, request: Request) -> Response:
        if request["user"] not in self.config.admins:
            return _err(403, "admin required")
        self.leader = False
        return json_response({"shutdown": "requested"}, status=202)

    # ------------------------------------------------------- replication
    # The Datomic tx-report role (datomic.clj:49): standbys tail the
    # leader's committed-event feed so failover works from the STANDBY's
    # own copy of the state — the leader's disk is not a single point of
    # durability.  Consumed by control/replication.py JournalFollower.

    REPLICATION_BATCH = 2000
    REPLICATION_MAX_WAIT_S = 25.0

    # --- wakeup plumbing (module docstring, "Lock order").  Commits
    # happen on arbitrary writer threads under the store lock; long-poll
    # and sync-ack waiters are request threads.  The store watcher and
    # every ack only bump a generation counter under `_repl_cond` and
    # notify it; a waiter reads the counter BEFORE testing its predicate
    # (under the loop lock), then parks until the counter moves, so a
    # wakeup between the test and the park is never lost.

    def _on_store_event(self, _event) -> None:
        """Store watcher: runs on the committing thread, under the store
        lock.  It may only bump and notify — taking the loop lock here
        would deadlock against a handler that holds the loop lock and
        waits for the store lock."""
        self._repl_wake_all()

    def _repl_wake_all(self) -> None:
        with self._repl_cond:
            self._repl_gen += 1
            self._repl_cond.notify_all()

    def _repl_wait(self, gen: int, timeout_s: float) -> None:
        """Park until the wakeup counter moves past `gen` (a commit, an
        ack, or the server closing) or `timeout_s` lapses, with the loop
        lock released so other requests — among them the ack that ends a
        sync-ack wait — are served meanwhile."""
        with self.loop.released(), self._repl_cond:
            self._repl_cond.wait_for(
                lambda: self._repl_gen != gen or self._repl_closed,
                max(0.0, timeout_s))

    def close_replication_waits(self) -> None:
        """Answer every parked long-poll and sync-ack wait now, and park
        no new one: the server is stopping (rest/server.py), and its
        handler threads must end before it closes."""
        with self._repl_cond:
            self._repl_closed = True
            self._repl_cond.notify_all()

    def _replication_store(self, shard: Optional[int]):
        """The store whose feed a follower asked for: shard i of a
        sharded store, or the whole (unsharded) store.  None = bad
        shard index."""
        shards = getattr(self.store, "shards", None)
        if shards is None:
            return self.store if shard in (None, 0) else None
        if shard is None:
            shard = 0
        if not 0 <= shard < len(shards):
            return None
        return shards[shard]

    def _journal_slice(self, after_seq: int, store=None):
        """Copy the event batch under the store lock; encode nothing
        there (events are immutable — serialization happens outside so
        standby polls never stall leader writes)."""
        store = store if store is not None else self.store
        with store._lock:
            last_seq = store.last_seq()
            window = store._events
            oldest = window[0].seq if window else None
            # follower ahead of us: it replicated from a leader history
            # we never saw (e.g. we are a deposed leader's standby that
            # outlived it) — only a snapshot bootstrap can converge it
            if after_seq > last_seq:
                return None, last_seq, False
            # gap: events in (after_seq, oldest) have been trimmed from
            # the window (or predate this process — e.g. a leader that
            # itself recovered from disk); the follower must re-bootstrap
            # from a full snapshot
            if after_seq < last_seq and (oldest is None
                                         or after_seq + 1 < oldest):
                return None, last_seq, False
            events = [e for e in window if e.seq > after_seq]
            batch = events[:self.REPLICATION_BATCH]
            return batch, last_seq, len(events) > len(batch)

    def get_replication_journal(self, request: Request) -> Response:
        """Committed-event feed for standbys (the Datomic tx-report role,
        datomic.clj:49).  `wait_s` long-polls: when the follower is caught
        up, the request parks until the next commit instead of returning
        empty — replication becomes push-like and write stalls don't scale
        with standby count."""
        if request["user"] not in self.config.admins:
            return _err(403, "admin required")
        try:
            after_seq = int(request.query.get("after_seq", "0"))
            wait_s = float(request.query.get("wait_s", "0"))
            shard = (int(request.query.get("shard"))
                     if request.query.get("shard") is not None else None)
        except ValueError:
            return _err(400, "after_seq/wait_s/shard must be numeric")
        wait_s = min(wait_s, self.REPLICATION_MAX_WAIT_S)
        target = self._replication_store(shard)
        if target is None:
            return _err(400, f"unknown shard {shard}")
        deadline = time.monotonic() + wait_s
        while True:
            gen = self._repl_gen
            batch, last_seq, more = self._journal_slice(after_seq, target)
            if batch is None:
                return json_response({
                    "snapshot_required": True, "last_seq": last_seq,
                    "incarnation": self.incarnation})
            if batch or self._repl_closed \
                    or time.monotonic() >= deadline:
                break
            self._repl_wait(gen, deadline - time.monotonic())
        # the encode runs with the loop lock released, as the reference
        # runs it in an executor
        with self.loop.released():
            encoded = [json.loads(e.to_json()) for e in batch]
        return json_response({
            "events": encoded,
            "last_seq": last_seq,
            "more": more,
            "incarnation": self.incarnation,
        })

    def get_replication_snapshot(self, request: Request) -> Response:
        if request["user"] not in self.config.admins:
            return _err(403, "admin required")
        from cook_tpu_torch.models import persistence

        try:
            shard = (int(request.query.get("shard"))
                     if request.query.get("shard") is not None else None)
        except ValueError:
            return _err(400, "shard must be an integer")
        target = self._replication_store(shard)
        if target is None:
            return _err(400, f"unknown shard {shard}")
        # snapshot_state copies entity references under the store lock
        # and encodes outside it; the loop lock is released for both, so
        # a large snapshot holds no other request back
        with self.loop.released():
            state = persistence.snapshot_state(target)
        state["incarnation"] = self.incarnation
        return json_response(state)

    def post_replication_ack(self, request: Request) -> Response:
        """Followers confirm the highest seq they have applied; only acks
        flagged `durable` (applied AND journaled on the follower's own
        disk) count toward the sync-ack bound — a memory-only follower
        confirming a write does not make it survive two machine losses.
        Absent flag defaults to durable for wire compatibility."""
        if request["user"] not in self.config.admins:
            return _err(403, "admin required")
        body = request.json()
        follower = str(body.get("follower", ""))
        try:
            seq = int(body.get("seq"))
        except (TypeError, ValueError):
            return _err(400, "seq must be an integer")
        if not follower:
            return _err(400, "follower required")
        durable = bool(body.get("durable", True))
        try:
            # sharded feeds ack per shard (sequence numbers are only
            # comparable within one shard's history); unsharded acks are
            # shard 0
            shard = int(body.get("shard", 0))
        except (TypeError, ValueError):
            return _err(400, "shard must be an integer")
        # correlation: the follower reports the txn id of the newest
        # txn/committed event its ack covers, so the ack is attributable
        # to the mutation it makes durable (and the span ring links it)
        last_txn_id = str(body.get("last_txn_id", "") or "")
        meta_key = follower if shard == 0 else f"{follower}[s{shard}]"
        self.replication_ack_meta[meta_key] = {
            "seq": seq, "durable": durable, "time": time.monotonic(),
            "last_txn_id": last_txn_id, "shard": shard,
            "follower": follower,
            # the follower's own REST URL (control/replication.py sends
            # it): the reference's fleet observatory polls it as a peer
            "url": str(body.get("url", "") or "")}
        global_registry.counter(
            "replication.acks",
            "replication acks received, split durable vs memory-only").inc(
            1, {"durable": str(durable).lower()})
        if durable:
            acks = self.replication_shard_acks.setdefault(shard, {})
            acks[follower] = max(acks.get(follower, 0), seq)
            if shard == 0:
                prev = self.replication_acks.get(follower, 0)
                self.replication_acks[follower] = max(prev, seq)
        if last_txn_id:
            from cook_tpu_torch.utils import tracing

            tracing.record_event("replication.ack", txn_id=last_txn_id,
                                 follower=follower, durable=durable)
        self._repl_wake_all()
        return json_response({"ok": True, "counted": durable})

    def _prune_stale_acks(self) -> None:
        """Drop ack entries whose follower has gone quiet for longer than
        the liveness window: a decommissioned standby's last ack (possibly
        a high seq from a diverged history) must not satisfy the
        durability bound forever."""
        ttl = self.config.replication_ack_liveness_s
        if ttl <= 0:
            return
        now = time.monotonic()
        for meta_key, meta in list(self.replication_ack_meta.items()):
            if now - meta["time"] > ttl:
                del self.replication_ack_meta[meta_key]
                follower = meta.get("follower", meta_key)
                shard = meta.get("shard", 0)
                self.replication_shard_acks.get(shard, {}).pop(
                    follower, None)
                if shard == 0:
                    self.replication_acks.pop(follower, None)

    def _await_replication(self, seq: int, shard: int = 0) -> bool:
        """Block until >= replication_min_acks LIVE, durable followers
        confirm `seq` ON `shard`, or the configured timeout lapses.
        True = durability bound met.  The acks are read under the loop
        lock (post_replication_ack writes them under it); the wait parks
        with it released."""
        deadline = time.monotonic() + self.config.replication_ack_timeout_s
        need = self.config.replication_min_acks
        while True:
            gen = self._repl_gen
            self._prune_stale_acks()
            acks = self.replication_shard_acks.get(shard, {})
            if shard == 0 and not acks:
                acks = self.replication_acks
            acked = sum(1 for s in acks.values() if s >= seq)
            if acked >= need:
                return True
            remaining = deadline - time.monotonic()
            if remaining <= 0 or self._repl_closed:
                return False
            self._repl_wait(gen, remaining)

    def _await_replication_outcome(self, outcome: TxnOutcome,
                                   walls: Optional[dict] = None) -> bool:
        """Sync-ack wait for one commit: every shard the transaction
        touched must meet the durability bound (a cross-shard commit is
        durable only when BOTH segments are replicated).  The shards are
        awaited in ascending order; with `walls` given, a sharded commit
        records each shard's wait as `replication_ack_s{i}` (shard i's
        wall counts from when the shards before it were acked)."""
        if outcome.shard_seqs:
            for shard, seq in sorted(outcome.shard_seqs.items()):
                t0 = time.perf_counter()
                met = self._await_replication(seq, shard)
                if walls is not None:
                    walls[f"replication_ack_s{shard}"] = \
                        time.perf_counter() - t0
                if not met:
                    return False
            return True
        return self._await_replication(outcome.seq)

    @staticmethod
    def _note_ack_timeout() -> None:
        global_registry.counter(
            "replication_ack_timeouts",
            "sync-ack replication bounds missed").inc()


def _res_json(res: Resources) -> dict:
    def clean(x):
        return x if x != float("inf") else 1e300
    return {"mem": clean(res.mem), "cpus": clean(res.cpus),
            "gpus": clean(res.gpus)}


def _err(status: int, message: str) -> Response:
    return json_response({"error": message}, status=status)


def _build_openapi(app: WebApplication) -> dict:
    """Minimal OpenAPI 3 doc generated from the registered routes."""
    paths: dict = {}
    for route in app.router.routes():
        path = route.template
        if path in ("/swagger-docs", "/swagger-ui"):
            continue
        handler_doc = (route.handler.__doc__ or "").strip().splitlines()
        summary = handler_doc[0] if handler_doc else route.handler.__name__
        paths.setdefault(path, {})[route.method.lower()] = {
            "summary": summary,
            "operationId": route.handler.__name__,
            "responses": {"200": {"description": "success"}},
        }
    return {
        "openapi": "3.0.0",
        "info": {"title": "cook-tpu scheduler API", "version": "0.1.0"},
        "paths": paths,
    }
