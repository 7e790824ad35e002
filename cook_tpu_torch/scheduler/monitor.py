"""Periodic stats gauges: per-user/pool usage, waiting counts, starvation.

A copy of `cook_tpu/scheduler/monitor.py` (jax-free), its imports rewritten to the
port's modules.

Reference: cook.monitor (scheduler/src/cook/monitor.clj):
`set-stats-counters!` publishes per-pool gauges of running/waiting users
and resources, total utilization, and "starved" users — users below their
share who have waiting work (monitor.clj:177).
"""
from __future__ import annotations

from dataclasses import dataclass

from cook_tpu_torch.models.entities import Resources
from cook_tpu_torch.models.store import Event, JobStore
from cook_tpu_torch.utils.metrics import global_registry

# job-lifecycle latencies span milliseconds (a hot match) to days (a
# starved batch queue) — the default request-scale buckets top out at 60s
LIFECYCLE_BUCKETS = (0.1, 0.5, 1.0, 5.0, 15.0, 30.0, 60.0, 120.0, 300.0,
                     600.0, 1800.0, 3600.0, 7200.0, 21600.0, 86400.0,
                     float("inf"))


def observe_commit_ack(seconds: float) -> None:
    """submit -> commit-ack: wall time the REST layer spent committing a
    submission (apply + journal fsync + replication wait).  Wide buckets:
    a commit stalled minutes on a recovering standby is exactly what this
    metric exists to expose, and must not collapse into +Inf.  The REST
    layer additionally feeds the same sample into its contention
    observatory's windowed SLO burn-rate tracker (rest/api.py) — the
    cumulative histogram can't answer "how fast are we burning budget
    RIGHT NOW"."""
    global_registry.histogram(
        "job.latency.submit_commit_ack",
        "seconds from submission arrival to durable commit ack",
        buckets=LIFECYCLE_BUCKETS,
    ).observe(seconds)


class JobLifecycleTracker:
    """Store watcher that turns lifecycle transitions into the job-latency
    SLO histograms exported at /metrics:

      * submit -> matched   (instance created for a waiting job)
      * matched -> running  (backend reported the task running)
      * submit -> completed (end-to-end)

    Times come from the store clock (virtual in the simulator, epoch ms in
    production), so the histograms measure scheduler-visible latency, not
    wall time spent in this process.

    `enabled` is the standby effect-gate (same pattern as the scheduler's
    kill fan-out): a passive node applies REPLICATED events at apply
    time, so a backlog replayed after downtime would observe latencies
    inflated by the outage — and the contaminated process-global
    histograms would survive promotion."""

    def __init__(self, store: JobStore, enabled=None):
        self.store = store
        self._enabled = enabled
        self._submit_to_matched = global_registry.histogram(
            "job.latency.submit_to_matched",
            "seconds from job submission to first match",
            buckets=LIFECYCLE_BUCKETS)
        self._matched_to_running = global_registry.histogram(
            "job.latency.matched_to_running",
            "seconds from match (instance created) to running",
            buckets=LIFECYCLE_BUCKETS)
        self._end_to_end = global_registry.histogram(
            "job.latency.end_to_end",
            "seconds from job submission to completion",
            buckets=LIFECYCLE_BUCKETS)
        store.add_watcher(self._on_event)

    def _on_event(self, event: Event) -> None:
        if self._enabled is not None and not self._enabled():
            return
        now_ms = self.store.clock()
        if event.kind == "instance/created":
            job = self.store.jobs.get(event.data.get("job", ""))
            # first instance only: a retry matched days later must not
            # re-observe the full submit->now interval into the
            # first-match histogram
            if job is not None and len(job.instance_ids) == 1:
                self._submit_to_matched.observe(
                    max(0.0, (now_ms - job.submit_time_ms) / 1000.0),
                    {"pool": job.pool})
        elif (event.kind == "instance/status"
              and event.data.get("status") == "running"):
            inst = self.store.instances.get(event.data.get("task_id", ""))
            if inst is not None:
                job = self.store.jobs.get(inst.job_uuid)
                self._matched_to_running.observe(
                    max(0.0, (now_ms - inst.start_time_ms) / 1000.0),
                    {"pool": job.pool} if job is not None else None)
        elif (event.kind == "job/state"
              and event.data.get("state") == "completed"):
            job = self.store.jobs.get(event.data.get("uuid", ""))
            if job is not None:
                self._end_to_end.observe(
                    max(0.0, (now_ms - job.submit_time_ms) / 1000.0),
                    {"pool": job.pool})


def starvation_stats(store: JobStore, pool: str,
                     *, top_users: int = 10) -> dict:
    """Queued-wait visibility for one pool: the oldest queued job's age,
    and per-user max waits (how long each user's most-starved job has
    sat WAITING, measured from `last_waiting_start_time_ms` on the store
    clock — a retried job's wait restarts when it re-queues).  Shared by
    `collect_pool_stats` (gauges), the contention observatory's
    `job-starvation` health check, and the `/unscheduled_jobs` echo."""
    now = store.clock()
    oldest_age_s = 0.0
    oldest_job = ""
    user_waits: dict[str, float] = {}
    waiting = store.pending_jobs(pool)
    for job in waiting:
        start = job.last_waiting_start_time_ms or job.submit_time_ms
        age_s = max(0.0, (now - start) / 1000.0)
        if age_s > oldest_age_s:
            oldest_age_s, oldest_job = age_s, job.uuid
        user_waits[job.user] = max(user_waits.get(job.user, 0.0), age_s)
    ranked = sorted(user_waits.items(), key=lambda kv: kv[1], reverse=True)
    stats = {
        "waiting_jobs": len(waiting),
        "oldest_age_s": oldest_age_s,
        "oldest_job": oldest_job,
        "user_max_wait_s": dict(ranked[:top_users]),
    }
    if ranked:
        stats["worst_user"], stats["worst_user_wait_s"] = ranked[0]
    return stats


# pool -> user labels currently exported on monitor.user_max_wait_seconds
# (so collect_pool_stats can retract users who stopped waiting)
_exported_user_waits: dict[str, set] = {}


@dataclass
class PoolStats:
    running_jobs: int
    waiting_jobs: int
    running_users: int
    waiting_users: int
    starved_users: int
    used: Resources
    waiting_demand: Resources


def collect_pool_stats(store: JobStore, pool: str) -> PoolStats:
    running = store.running_jobs(pool)
    waiting = store.pending_jobs(pool)
    usage = store.user_usage(pool)
    waiting_users = {j.user for j in waiting}
    used = Resources()
    for r in usage.values():
        used = used + r
    demand = Resources()
    for job in waiting:
        demand = demand + job.resources

    starved = 0
    for user in waiting_users:
        share = store.get_share(user, pool)
        u = usage.get(user, Resources())
        # starved: waiting work while using less than their share
        if (u.mem < share.mem and u.cpus < share.cpus) or not usage.get(user):
            starved += 1

    stats = PoolStats(
        running_jobs=len(running),
        waiting_jobs=len(waiting),
        running_users=len(usage),
        waiting_users=len(waiting_users),
        starved_users=starved,
        used=used,
        waiting_demand=demand,
    )
    labels = {"pool": pool}
    g = global_registry.gauge
    g("monitor.running_jobs", "running jobs per pool").set(
        stats.running_jobs, labels)
    g("monitor.waiting_jobs", "waiting jobs per pool").set(
        stats.waiting_jobs, labels)
    g("monitor.running_users", "users with running work per pool").set(
        stats.running_users, labels)
    g("monitor.waiting_users", "users with waiting work per pool").set(
        stats.waiting_users, labels)
    g("monitor.starved_users",
      "users below their share with waiting work").set(
        stats.starved_users, labels)
    g("monitor.used_mem", "running memory usage (MB) per pool").set(
        stats.used.mem, labels)
    g("monitor.used_cpus", "running cpu usage per pool").set(
        stats.used.cpus, labels)
    g("monitor.waiting_mem", "waiting memory demand (MB) per pool").set(
        stats.waiting_demand.mem, labels)
    g("monitor.waiting_cpus", "waiting cpu demand per pool").set(
        stats.waiting_demand.cpus, labels)
    # starvation visibility: the age of the pool's oldest queued job and
    # each (top-10) user's most-starved wait — the signal that flips the
    # `job-starvation` degradation at /debug/health
    sv = starvation_stats(store, pool)
    g("monitor.oldest_waiting_age_seconds",
      "age of the oldest queued job per pool").set(
        sv["oldest_age_s"], labels)
    user_gauge = g("monitor.user_max_wait_seconds",
                   "longest current queued wait per user (top waiting "
                   "users)")
    # a user who scheduled (or fell out of the top set) must stop being
    # exported — a frozen last value reads as ongoing starvation, and
    # the label set would otherwise grow with workload user churn
    for user in _exported_user_waits.get(pool, set()) - \
            set(sv["user_max_wait_s"]):
        user_gauge.remove({"pool": pool, "user": user})
    for user, wait_s in sv["user_max_wait_s"].items():
        user_gauge.set(wait_s, {"pool": pool, "user": user})
    _exported_user_waits[pool] = set(sv["user_max_wait_s"])
    return stats


def collect_all(store: JobStore) -> dict[str, PoolStats]:
    return {pool: collect_pool_stats(store, pool) for pool in store.pools}
