"""Fairness observatory: per-user DRU trajectories, preemption ledger,
wasted-work accounting.

A copy of `cook_tpu/obs/fairness.py` (jax-free there too), importing the
port's own metrics registry and reason table.

Cook's reason to exist is DRU fair-share ranking plus rebalancer
preemption, and until now the fairness engine was the one subsystem
without an observatory: no share-vs-usage view per user, no record of
who preempted whom, no measure of work destroyed by a kill.  This
module closes that gap with three instruments:

  * a **DRU trajectory** sampler — `observe_rank()` runs at rank-cycle
    time with the `RankedQueue` in hand and records, per (pool, user):
    share, quota, running dominant-resource usage, running DRU score
    (dominant usage over share), best queued DRU, and queued depth.
    The headline numbers are exported as `fairness.user.*` gauges so
    the PR 15 tsdb samples them into durable history (`cs history
    fairness.user.dru` sparklines a user's drift); label churn is
    bounded both here (top-`max_users_per_pool` by DRU, departed users
    retracted) and in the tsdb (series TTL pruning).

  * a **preemption ledger** — `record_decisions()` is fed by the
    scheduler for every rebalancer decision it transacts: preemptor
    job/user, per-victim task/user/DRU-at-decision, resources freed,
    and **wasted-work seconds** (the victim instance's runtime at
    kill).  Entries live in a bounded ring; rollups accumulate per
    pool and per user.  Wasted work is split `fairness` (rebalancer
    preemptions — deliberate, fair-share-driven) vs `mea-culpa`
    (other scheduler-fault kills, e.g. container-preempted, reported
    through `note_kill()`).  The per-pool **fragmentation** stat is
    block-aware: each ledger entry carries the topology block of the
    host it freed (stamped by the scheduler from the same block
    decomposition the hierarchical matcher solves), `contiguous_share`
    is the largest single BLOCK's freed total over everything freed in
    the ledger window, and `fragmentation` is its complement — freeing
    three hosts in one block beats freeing three across the fleet,
    because only the former admits a gang.  Topology-aware victim
    selection (scheduler/gang.py) pushes it down.

  * **Jain fairness index** + drift detection — each rank cycle folds
    per-user running DRU into Jain's index `(Σx)²/(n·Σx²)` and feeds a
    `RollingBaseline` per pool; a sustained drop (recent median below
    the MAD band) raises the `fairness-drift` health reason, which the
    REST health verdict merges and the incident recorder snapshots
    (the `fairness` collector lands trajectories + ledger in every
    bundle).

Thread-safety: rank/rebalance cycles run on the scheduler thread but
REST snapshots arrive from aiohttp executors, so all mutation and
reads go through one lock (same discipline as ContentionObservatory).
"""
from __future__ import annotations

import collections
import threading
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..utils.metrics import global_registry

# Health reason raised on a sustained Jain-index drop.  Deliberately NOT
# in health.DEGRADATION_REASONS: HealthMonitor.verdict() zeroes the
# reason_active gauge for every reason in that tuple on each device-side
# verdict, and fairness is evaluated on a different path (the REST
# health merge) — the observatory owns its own gauge lifecycle.
FAIRNESS_DRIFT = "fairness-drift"

_INF = float("inf")


@dataclass
class FairnessConfig:
    """Bounds and drift knobs for the observatory."""

    ledger_capacity: int = 512       # preemption-ledger ring size
    max_users_per_pool: int = 64     # trajectory gauge/label cap per pool
    max_rollup_users: int = 256      # per-user rollup cap per pool
    # Jain-index drift baseline (RollingBaseline knobs).  A healthy
    # pool's index hovers near a stable level; sustained relative drops
    # past 10% of baseline flag drift.
    baseline_window: int = 64
    baseline_recent: int = 8
    baseline_min_samples: int = 12
    baseline_k_mad: float = 6.0
    baseline_rel_floor: float = 0.10


def jain_index(values) -> float:
    """Jain's fairness index (Σx)²/(n·Σx²) over non-negative samples.

    1.0 = perfectly even allocation, →1/n as one user dominates.  An
    empty or all-zero population is vacuously fair (1.0).
    """
    xs = [float(v) for v in values if v > 0.0]
    if not xs:
        return 1.0
    total = sum(xs)
    sq = sum(x * x for x in xs)
    return (total * total) / (len(xs) * sq)


def _res_dict(mem: float = 0.0, cpus: float = 0.0, gpus: float = 0.0) -> dict:
    return {"mem": round(float(mem), 3), "cpus": round(float(cpus), 3),
            "gpus": round(float(gpus), 3)}


def _finite(v: float) -> Optional[float]:
    return None if v == _INF else v


@dataclass
class _PoolRollup:
    """Accumulated preemption accounting for one pool."""

    preemptions: int = 0          # rebalancer decisions transacted
    tasks_preempted: int = 0
    wasted_fairness_s: float = 0.0
    wasted_mea_culpa_s: float = 0.0
    freed_mem: float = 0.0
    freed_cpus: float = 0.0
    freed_gpus: float = 0.0
    # user -> {"victim_tasks", "victim_wasted_s", "preemptions_initiated"}
    by_user: dict = field(default_factory=dict)
    users_truncated: int = 0

    def user_slot(self, user: str, cap: int) -> dict:
        slot = self.by_user.get(user)
        if slot is None:
            if len(self.by_user) >= cap:
                self.users_truncated += 1
                user = "(other)"
                slot = self.by_user.get(user)
                if slot is not None:
                    return slot
            slot = {"victim_tasks": 0, "victim_wasted_s": 0.0,
                    "preemptions_initiated": 0}
            self.by_user[user] = slot
        return slot

    def to_json(self) -> dict:
        return {
            "preemptions": self.preemptions,
            "tasks_preempted": self.tasks_preempted,
            "wasted_s": {
                "fairness": round(self.wasted_fairness_s, 3),
                "mea_culpa": round(self.wasted_mea_culpa_s, 3),
            },
            "freed": _res_dict(self.freed_mem, self.freed_cpus,
                               self.freed_gpus),
            "by_user": {u: dict(v) for u, v in self.by_user.items()},
            "users_truncated": self.users_truncated,
        }


class FairnessObservatory:
    """Per-user DRU trajectories + preemption ledger + drift detection.

    Owned by the Scheduler (one per process); scheduler-less REST nodes
    (mp shard-group workers) stand up their own so `/debug/fairness`
    scatter-merges cleanly across the fleet.
    """

    def __init__(self, config: Optional[FairnessConfig] = None,
                 clock: Optional[Callable[[], float]] = None):
        from .baseline import RollingBaseline

        self.config = config or FairnessConfig()
        self.clock = clock or (lambda: 0.0)
        self._lock = threading.Lock()
        self._ledger: collections.deque = collections.deque(
            maxlen=self.config.ledger_capacity)
        self._rollups: dict[str, _PoolRollup] = {}
        # pool -> {user: trajectory point}; refreshed whole each rank
        self._trajectories: dict[str, dict[str, dict]] = {}
        self._traj_truncated: dict[str, int] = {}
        self._jain: dict[str, float] = {}
        self._baseline_cls = RollingBaseline
        self._baselines: dict[str, "RollingBaseline"] = {}
        # pool -> set of users with exported per-user gauges (retraction
        # bookkeeping, same idiom as monitor._exported_user_waits)
        self._exported_users: dict[str, set] = {}
        self._drift_active: bool = False

    # ------------------------------------------------------- trajectories

    def observe_rank(self, pool: str, queue, store) -> None:
        """Sample per-user DRU trajectories from one pool's rank cycle.

        `queue` is the RankedQueue just produced (jobs in fair-share
        order + per-job queue DRU); `store` supplies shares, quotas and
        running usage.  Runs on the scheduler thread once per rank
        cycle — cheap enough to always be on.
        """
        cfg = self.config
        usage = store.user_usage(pool)
        queued: dict[str, int] = {}
        queue_dru: dict[str, float] = {}
        for job in queue.jobs:
            queued[job.user] = queued.get(job.user, 0) + 1
            d = queue.dru.get(job.uuid)
            if d is not None:
                prev = queue_dru.get(job.user)
                if prev is None or d < prev:
                    queue_dru[job.user] = float(d)

        users = set(usage) | set(queued)
        points: dict[str, dict] = {}
        for user in users:
            share = store.get_share(user, pool)
            quota = store.get_quota(user, pool)
            used = usage.get(user)
            dru = 0.0
            if used is not None:
                dru = max(
                    used.mem / share.mem if share.mem > 0 else 0.0,
                    used.cpus / share.cpus if share.cpus > 0 else 0.0,
                    used.gpus / share.gpus if share.gpus > 0 else 0.0,
                )
            points[user] = {
                "share": {"mem": _finite(share.mem),
                          "cpus": _finite(share.cpus),
                          "gpus": _finite(share.gpus)},
                "quota": {"mem": _finite(quota.resources.mem),
                          "cpus": _finite(quota.resources.cpus),
                          "count": (quota.count if quota.count < 2**31
                                    else None)},
                "usage": (_res_dict(used.mem, used.cpus, used.gpus)
                          if used is not None else _res_dict()),
                "dru": round(dru, 6),
                "queue_dru": (round(queue_dru[user], 6)
                              if user in queue_dru else None),
                "queued": queued.get(user, 0),
            }

        # Bound the kept set: top users by (running DRU, queued depth).
        truncated = 0
        if len(points) > cfg.max_users_per_pool:
            keep = sorted(points,
                          key=lambda u: (points[u]["dru"],
                                         points[u]["queued"]),
                          reverse=True)[:cfg.max_users_per_pool]
            truncated = len(points) - len(keep)
            points = {u: points[u] for u in keep}

        jain = jain_index(p["dru"] for p in points.values())

        dru_gauge = global_registry.gauge(
            "fairness.user.dru",
            "per-user running dominant-resource usage over share")
        queued_gauge = global_registry.gauge(
            "fairness.user.queued",
            "per-user pending jobs in the ranked queue")
        with self._lock:
            for user, point in points.items():
                labels = {"pool": pool, "user": user}
                dru_gauge.set(point["dru"], labels)
                queued_gauge.set(float(point["queued"]), labels)
            for user in self._exported_users.get(pool, set()) - set(points):
                dru_gauge.remove({"pool": pool, "user": user})
                queued_gauge.remove({"pool": pool, "user": user})
            self._exported_users[pool] = set(points)
            self._trajectories[pool] = points
            self._traj_truncated[pool] = truncated
            self._jain[pool] = jain
            baseline = self._baselines.get(pool)
            if baseline is None:
                baseline = self._baseline_cls(
                    window=cfg.baseline_window, recent=cfg.baseline_recent,
                    min_samples=cfg.baseline_min_samples,
                    k_mad=cfg.baseline_k_mad,
                    rel_floor=cfg.baseline_rel_floor)
                self._baselines[pool] = baseline
            baseline.add(jain)
        global_registry.gauge(
            "fairness.jain_index",
            "Jain fairness index over per-user running DRU").set(
                jain, {"pool": pool})

    # ------------------------------------------------------------- ledger

    def record_decisions(self, pool: str, entries: list[dict]) -> dict:
        """Append transacted rebalancer decisions to the ledger.

        Each entry: {t_ms, preemptor_job, preemptor_user, hostname,
        min_preempted_dru, victims: [{task_id, user, dru, wasted_s,
        mem, cpus, gpus}], freed: {mem, cpus, gpus}, wasted_s}.
        Returns this cycle's rollup (for CycleRecord.fairness).
        """
        cap = self.config.max_rollup_users
        cycle_tasks = 0
        cycle_wasted = 0.0
        with self._lock:
            rollup = self._rollups.setdefault(pool, _PoolRollup())
            for entry in entries:
                victims = entry.get("victims", [])
                wasted = sum(v.get("wasted_s", 0.0) for v in victims)
                entry = dict(entry, pool=pool, kind="fairness",
                             wasted_s=round(wasted, 3))
                self._ledger.append(entry)
                rollup.preemptions += 1
                rollup.tasks_preempted += len(victims)
                rollup.wasted_fairness_s += wasted
                freed = entry.get("freed", {})
                rollup.freed_mem += freed.get("mem", 0.0)
                rollup.freed_cpus += freed.get("cpus", 0.0)
                rollup.freed_gpus += freed.get("gpus", 0.0)
                slot = rollup.user_slot(entry.get("preemptor_user", ""), cap)
                slot["preemptions_initiated"] += 1
                for victim in victims:
                    vslot = rollup.user_slot(victim.get("user", ""), cap)
                    vslot["victim_tasks"] += 1
                    vslot["victim_wasted_s"] = round(
                        vslot["victim_wasted_s"] + victim.get("wasted_s", 0.0),
                        3)
                cycle_tasks += len(victims)
                cycle_wasted += wasted
            jain = self._jain.get(pool)
        if entries:
            global_registry.counter(
                "fairness.preemptions",
                "rebalancer preemption decisions transacted").inc(
                    len(entries), {"pool": pool})
            global_registry.counter(
                "fairness.preempted_tasks",
                "victim tasks killed by rebalancer preemption").inc(
                    cycle_tasks, {"pool": pool})
            global_registry.counter(
                "fairness.wasted_work_seconds",
                "victim instance runtime destroyed at kill, by kind").inc(
                    cycle_wasted, {"pool": pool, "kind": "fairness"})
            frag = self._fragmentation(pool)
            global_registry.gauge(
                "fairness.fragmentation",
                "1 - largest within-one-topology-block freed capacity "
                "over total freed (ledger window)").set(
                    frag["fragmentation"], {"pool": pool})
        return {
            "preemptions": len(entries),
            "tasks_preempted": cycle_tasks,
            "wasted_s": round(cycle_wasted, 3),
            "jain_index": jain,
        }

    def note_kill(self, pool: str, user: str, task_id: str,
                  wasted_s: float, reason: str = "") -> None:
        """Account a non-rebalancer mea-culpa kill (e.g. the backing
        cluster preempted the container).  The runtime destroyed lands
        in the `mea_culpa` wasted-work bucket; no ledger entry — there
        is no preemptor, and the instance event stream already records
        the kill itself.
        """
        with self._lock:
            rollup = self._rollups.setdefault(pool, _PoolRollup())
            rollup.wasted_mea_culpa_s += wasted_s
            slot = rollup.user_slot(user, self.config.max_rollup_users)
            slot["victim_wasted_s"] = round(
                slot["victim_wasted_s"] + wasted_s, 3)
        global_registry.counter(
            "fairness.wasted_work_seconds",
            "victim instance runtime destroyed at kill, by kind").inc(
                wasted_s, {"pool": pool, "kind": "mea-culpa"})

    def victim_detail(self, task_id: str) -> Optional[dict]:
        """Ledger lookup for one victim task (newest entry wins) — the
        timeline's preemption-detail source."""
        with self._lock:
            for entry in reversed(self._ledger):
                for victim in entry.get("victims", ()):
                    if victim.get("task_id") == task_id:
                        return {
                            "preemptor_user": entry.get("preemptor_user", ""),
                            "preemptor_job": entry.get("preemptor_job", ""),
                            "dru_at_decision": victim.get("dru"),
                            "runtime_lost_s": victim.get("wasted_s"),
                            "t_ms": entry.get("t_ms"),
                        }
        return None

    def _fragmentation(self, pool: str) -> dict:
        """Block-aware contiguous-capacity share of freed memory over the
        ledger window: decisions carry the topology block their host
        belongs to (stamped by Scheduler.rebalance_cycle), freed memory
        accumulates per block, and `contiguous_share` is the LARGEST
        single block's freed total over everything freed — capacity
        returned scattered across blocks scores fragmented even when each
        individual kill freed a big host, because no gang can use it
        whole.  Entries without a block stamp (older ledgers, recovery)
        fall back to per-decision chunks.  Caller holds no lock (reads
        the deque snapshot-style; appends are the only mutation and
        deques are safe to iterate under the GIL via list())."""
        per_block: dict = {}
        total = 0.0
        n = 0
        for entry in list(self._ledger):
            if entry.get("pool") != pool or entry.get("kind") != "fairness":
                continue
            freed = entry.get("freed", {}).get("mem", 0.0)
            total += freed
            n += 1
            block = entry.get("block")
            key = (("block", block) if isinstance(block, int) and block >= 0
                   else ("entry", n))
            per_block[key] = per_block.get(key, 0.0) + freed
        best = max(per_block.values(), default=0.0)
        share = best / total if total > 0 else 1.0
        return {"contiguous_share": round(share, 4),
                "fragmentation": round(1.0 - share, 4),
                "decisions": n,
                "blocks": sum(1 for k in per_block if k[0] == "block")}

    # ----------------------------------------------------------- recovery

    def recover(self, store) -> int:
        """Rebuild wasted-work rollups from the store after failover.

        The ledger itself is in-memory state lost with the leader, but
        terminal instances carry reason codes, so the durable journal is
        enough to restore the rollup totals (preemptor attribution is
        gone — recovered entries count victims only).  Returns the
        number of preempted instances replayed.
        """
        from ..models.reasons import REASONS_BY_CODE

        replayed = 0
        try:
            jobs = list(store.jobs.values())
        except AttributeError:
            return 0
        cap = self.config.max_rollup_users
        with self._lock:
            for job in jobs:
                for inst in store.job_instances(job.uuid):
                    if not inst.status.terminal or inst.reason_code is None:
                        continue
                    reason = REASONS_BY_CODE.get(inst.reason_code)
                    if reason is None or not reason.mea_culpa:
                        continue
                    wasted = 0.0
                    # start_time_ms is clock-stamped at create (0 is a
                    # real start under a virtual clock); end guards the
                    # never-terminal edge only
                    if inst.end_time_ms:
                        wasted = max(
                            0.0,
                            (inst.end_time_ms - inst.start_time_ms) / 1000.0)
                    rollup = self._rollups.setdefault(job.pool, _PoolRollup())
                    if reason.name == "preempted-by-rebalancer":
                        rollup.tasks_preempted += 1
                        rollup.wasted_fairness_s += wasted
                    else:
                        rollup.wasted_mea_culpa_s += wasted
                    slot = rollup.user_slot(job.user, cap)
                    slot["victim_tasks"] += 1
                    slot["victim_wasted_s"] = round(
                        slot["victim_wasted_s"] + wasted, 3)
                    replayed += 1
        return replayed

    # -------------------------------------------------------------- drift

    def health_degradations(self) -> list[dict]:
        """Per-pool `fairness-drift` degradations (sustained Jain-index
        drop below the rolling baseline band).  Also owns the
        `obs.health.reason_active{reason="fairness-drift"}` gauge.
        """
        out = []
        with self._lock:
            baselines = dict(self._baselines)
        for pool, baseline in sorted(baselines.items()):
            snap = baseline.anomaly_low()
            if snap is not None:
                out.append({
                    "reason": FAIRNESS_DRIFT,
                    "pool": pool,
                    "detail": (
                        f"jain index {snap['recent']:.3f} sustained below "
                        f"baseline {snap['baseline']:.3f} "
                        f"(band {snap['band']:.3f})"),
                    **{k: snap[k] for k in
                       ("baseline", "recent", "deviation", "n")},
                })
        active = bool(out)
        if active or self._drift_active:
            global_registry.gauge(
                "obs.health.reason_active",
                "1 while a degradation reason is firing").set(
                    1.0 if active else 0.0, {"reason": FAIRNESS_DRIFT})
        self._drift_active = active
        return out

    def health_checks(self) -> dict:
        """Per-pool Jain index + baseline snapshot for the health
        verdict's `checks.fairness` block."""
        with self._lock:
            jain = dict(self._jain)
            baselines = dict(self._baselines)
        return {
            pool: {
                "jain_index": round(jain.get(pool, 1.0), 4),
                "baseline": baselines[pool].snapshot()
                if pool in baselines else None,
            }
            for pool in sorted(set(jain) | set(baselines))
        }

    # ----------------------------------------------------------- surfaces

    def snapshot(self, pool: Optional[str] = None,
                 ledger_limit: int = 50) -> dict:
        """The `/debug/fairness` body.  Shape is mp-scatter-merge-safe:
        everything lives under per-pool keys (pools are group-owned and
        disjoint across shard groups, so the front end's dict-union
        merge composes bodies without summing anything)."""
        with self._lock:
            pools = sorted(set(self._trajectories) | set(self._rollups)
                           | set(self._jain))
            if pool is not None:
                pools = [p for p in pools if p == pool]
            ledger = list(self._ledger)
            body_pools = {}
            for p in pools:
                traj = dict(self._trajectories.get(p, {}))
                truncated = self._traj_truncated.get(p, 0)
                rollup = self._rollups.get(p)
                baseline = self._baselines.get(p)
                pool_ledger = [e for e in ledger if e.get("pool") == p]
                body_pools[p] = {
                    "jain_index": round(self._jain.get(p, 1.0), 4),
                    "jain_baseline": baseline.snapshot()
                    if baseline is not None else None,
                    "trajectories": traj,
                    "trajectories_truncated": truncated,
                    "rollups": rollup.to_json() if rollup is not None
                    else _PoolRollup().to_json(),
                    "fragmentation": self._fragmentation(p),
                    "ledger": pool_ledger[-ledger_limit:],
                }
        return {"enabled": True, "pools": body_pools}

    def collector(self) -> dict:
        """Incident-bundle evidence: bounded snapshot."""
        return self.snapshot(ledger_limit=20)
