#!/usr/bin/env python
"""Chaos scenario suite: inject faults, observe the verdict AND the
reaction, assert full recovery.

Port of `tools/chaos.py`.  Each scenario drives the REAL control plane
(rest/server.py InprocessControlPlane: real store lock, real journal
fsyncs, real REST stack) or the REAL scheduler (JobStore + MockCluster +
Scheduler, solving on `--device`) with a seeded
`cook_tpu_torch.faults.FaultSchedule` armed, and asserts three things in
order:

  1. the fault is OBSERVED: the matching `/debug/health` reason (or
     telemetry verdict) appears;
  2. the automatic REACTION engages: 429 shedding, circuit-breaker
     open + `cluster-circuit-open` skips, degraded-async journal,
     follower backoff; a failed device solve raises and launches nothing
     (the port re-solves nothing on the CPU);
  3. after the fault clears, the system RECOVERS: health returns to ok,
     the queue drains, no acked transaction is lost, no task is launched
     twice.

The reference's `device-fallback` scenario (the failing cycle re-solved
on the CPU) is `device-error` here: the port has no device-fallback
ladder, so the scenario holds the port's own reaction instead.

    python -m cook_tpu_torch.tools.chaos --smoke       # the fast CI set
    python -m cook_tpu_torch.tools.chaos               # the full matrix
    python -m cook_tpu_torch.tools.chaos --scenario launch-breaker
    python -m cook_tpu_torch.tools.chaos --smoke --device cpu
    python -m cook_tpu_torch.tools.chaos --list

Wired into `cook_tpu_torch/tools/ci_checks.py` as the `chaos_smoke` step;
the full matrix is the operator's chaos-drill entry point.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
import urllib.error
import urllib.request
from dataclasses import dataclass, field

ADMIN = {"X-Cook-Requesting-User": "admin",
         "Content-Type": "application/json"}


class ChaosFailure(AssertionError):
    """A scenario invariant did not hold."""


@dataclass
class ScenarioResult:
    name: str
    passed: bool
    seconds: float
    steps: list = field(default_factory=list)
    error: str = ""

    def to_dict(self) -> dict:
        return {"name": self.name, "passed": self.passed,
                "seconds": round(self.seconds, 2), "steps": self.steps,
                "error": self.error}


def _check(cond, message: str) -> None:
    if not cond:
        raise ChaosFailure(message)


def _wait_until(pred, *, timeout_s: float, interval_s: float = 0.1,
                what: str = "condition"):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout_s:
        value = pred()
        if value:
            return value
        time.sleep(interval_s)
    raise ChaosFailure(f"timed out after {timeout_s}s waiting for {what}")


# ----------------------------------------------------------- http helpers


def _get(url: str, timeout: float = 10.0):
    req = urllib.request.Request(url, headers=ADMIN)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), json.loads(r.read() or b"{}")
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), {}


def _post(url: str, payload: dict, timeout: float = 30.0):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers=ADMIN, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read() or b"{}")
    except urllib.error.HTTPError as e:
        return e.code, {}


def _submit_jobs(url: str, n: int, prefix: str) -> list:
    uuids = []
    for i in range(n):
        uuid = f"{prefix}-{i:04d}"
        status, _ = _post(f"{url}/jobs", {"jobs": [{
            "uuid": uuid, "command": "true", "mem": 64, "cpus": 0.1}]})
        _check(status == 201, f"submit {uuid} -> {status}")
        uuids.append(uuid)
    return uuids


# -------------------------------------------------------- scheduler rig


class _Clock:
    """Manually-advanced ms clock for the scheduler scenarios."""

    def __init__(self):
        self.ms = 0

    def __call__(self) -> int:
        return self.ms


def _scheduler_rig(*, n_hosts: int, n_jobs: int, device: str,
                   job_prefix: str = "job"):
    from cook_tpu_torch.cluster.mock import MockCluster, MockHost
    from cook_tpu_torch.models.entities import Job, Pool, Resources
    from cook_tpu_torch.models.store import JobStore
    from cook_tpu_torch.scheduler.core import Scheduler, SchedulerConfig
    from cook_tpu_torch.scheduler.matcher import MatchConfig

    clock = _Clock()
    store = JobStore(clock=clock)
    store.set_pool(Pool(name="default"))
    hosts = [MockHost(node_id=f"h{i}", hostname=f"h{i}", mem=4000, cpus=8)
             for i in range(n_hosts)]
    cluster = MockCluster("chaos", hosts, clock=clock)
    scheduler = Scheduler(store, [cluster], SchedulerConfig(
        match=MatchConfig(chunk=0)), device=device)
    jobs = [Job(uuid=f"{job_prefix}-{i:03d}", user=f"u{i % 3}",
                pool="default", command="true",
                resources=Resources(mem=200, cpus=1), max_retries=5)
            for i in range(n_jobs)]
    store.submit_jobs(jobs)
    return clock, store, cluster, scheduler, jobs


def _match_once(scheduler, store, clock) -> object:
    pool = store.pools["default"]
    scheduler.rank_cycle(pool)
    outcome = scheduler.match_cycle(pool)
    clock.ms += 1000
    return outcome


# -------------------------------------------------------------- scenarios


def scenario_fsync_stall_sheds() -> list:
    """journal.fsync delay -> fsync-stall + commit-ack-slo-burn -> heavy
    reads shed 429 + Retry-After -> clear -> health ok, every acked job
    survives, reads serve again."""
    from cook_tpu_torch import faults
    from cook_tpu_torch.obs.contention import ContentionParams, SloBurnTracker
    from cook_tpu_torch.rest.api import ApiConfig
    from cook_tpu_torch.rest.server import InprocessControlPlane

    steps = []
    # thresholds sized so an honest-but-loaded CI disk (tens of ms per
    # real fsync) never trips them, while the injected 300ms stall
    # clears both by 3x
    params = ContentionParams(
        fsync_stall_s=0.25, commit_ack_slo_s=0.10, commit_ack_budget=0.05,
        burn_fast_s=1.5, burn_slow_s=3.0, burn_threshold=1.0,
        lock_min_acquisitions=1_000_000_000)
    cp = InprocessControlPlane(config=ApiConfig(contention=params)).start()
    try:
        # fine-grained burn buckets + a snappy shed cache so the
        # scenario observes engagement AND recovery in seconds
        cp.api.contention.commit_ack = SloBurnTracker(bucket_s=0.5,
                                                      retention_s=120.0)
        cp.api.shedder.ttl_s = 0.2
        faults.arm(faults.FaultSchedule([faults.FaultRule(
            point=faults.JOURNAL_FSYNC, mode="delay", delay_s=0.3)]))
        acked = _submit_jobs(cp.url, 10, "stall")
        steps.append(f"submitted {len(acked)} jobs under a 300ms fsync "
                     f"stall (all acked)")

        status, _, health = _get(f"{cp.url}/debug/health")
        reasons = set(health.get("reasons", []))
        _check("fsync-stall" in reasons,
               f"expected fsync-stall in {sorted(reasons)}")
        _check("commit-ack-slo-burn" in reasons,
               f"expected commit-ack-slo-burn in {sorted(reasons)}")
        steps.append(f"health degraded: {sorted(reasons)}")

        status, headers, _ = _get(f"{cp.url}/queue")
        _check(status == 429, f"expected 429 from /queue, got {status}")
        _check("Retry-After" in headers, "429 without Retry-After")
        steps.append(f"reaction: /queue shed 429, Retry-After="
                     f"{headers['Retry-After']}s")

        faults.disarm()
        time.sleep(3.6)  # both burn windows roll past the bad buckets
        # fresh clean commits roll the fsync-stall window (64 fsyncs)
        acked += _submit_jobs(cp.url, 70, "post")

        def healthy():
            _, _, h = _get(f"{cp.url}/debug/health")
            return not h.get("reasons")
        _wait_until(healthy, timeout_s=20.0, what="health ok")
        steps.append("fault cleared: health back to ok")

        status, _, _ = _get(f"{cp.url}/queue")
        _check(status != 429, f"/queue still shed after recovery "
                              f"({status})")
        for uuid in acked:
            status, _, _ = _get(f"{cp.url}/jobs/{uuid}")
            _check(status == 200, f"acked job {uuid} lost ({status})")
        steps.append(f"invariant: all {len(acked)} acked jobs present, "
                     f"reads serving")
        return steps
    finally:
        faults.disarm()
        cp.stop()


def scenario_launch_breaker(device: str) -> list:
    """cluster.launch failures -> mea-culpa launch-failed flow-back ->
    breaker opens (accepts_work False, jobs skip cluster-circuit-open,
    no instance churn) -> cooldown -> half-open probe launch succeeds ->
    breaker closes, queue drains, no task launched twice."""
    from cook_tpu_torch import faults
    from cook_tpu_torch.faults.breaker import BreakerParams, BreakerState
    from cook_tpu_torch.models.entities import JobState
    from cook_tpu_torch.scheduler import flight_recorder as flight_codes

    steps = []
    clock, store, cluster, scheduler, jobs = _scheduler_rig(
        n_hosts=6, n_jobs=8, device=device, job_prefix="brk")
    breaker = cluster.configure_breaker(BreakerParams(
        window=4, min_samples=2, error_threshold=0.5, cooldown_s=0.3))
    faults.arm(faults.FaultSchedule([faults.FaultRule(
        point=faults.CLUSTER_LAUNCH, mode="error", times=2,
        match={"cluster": "chaos"})]))
    try:
        for _ in range(2):
            _match_once(scheduler, store, clock)
        _check(breaker.state is BreakerState.OPEN,
               f"breaker should be open, is {breaker.state}")
        _check(not cluster.accepts_work, "open breaker still accepts work")
        failed_attempts = len(store.instances)
        steps.append(f"2 launch RPC failures -> {failed_attempts} "
                     f"mea-culpa launch-failed attempts, breaker OPEN")

        _match_once(scheduler, store, clock)  # open cycle: jobs skip
        _check(len(store.instances) == failed_attempts,
               "open breaker cycle still transacted launches")
        code = scheduler.recorder.job_reason(jobs[0].uuid)[1]
        _check(code == flight_codes.CLUSTER_CIRCUIT_OPEN,
               f"expected cluster-circuit-open skip, got {code}")
        steps.append("reaction: offers withheld, jobs skip "
                     "cluster-circuit-open (no mea-culpa burn)")

        faults.disarm()  # (rule exhausted anyway: times=2)
        time.sleep(0.35)  # cooldown -> half-open on next accepts_work
        for _ in range(4):
            _match_once(scheduler, store, clock)
            if all(store.jobs[j.uuid].state is JobState.RUNNING
                   for j in jobs):
                break
        _check(breaker.state is BreakerState.CLOSED,
               f"probe should close the breaker, is {breaker.state}")
        for j in jobs:
            _check(store.jobs[j.uuid].state is JobState.RUNNING,
                   f"{j.uuid} not running after recovery "
                   f"({store.jobs[j.uuid].state})")
        steps.append("recovery: half-open probe launch succeeded, "
                     "breaker CLOSED, all 8 jobs running (queue drained)")

        # no duplicate launch: every live backend task belongs to exactly
        # one store instance, and each job has exactly one live attempt
        live = [i for i in store.instances.values()
                if not i.status.terminal]
        _check(len(live) == len(jobs),
               f"{len(live)} live instances for {len(jobs)} jobs")
        _check(len({i.task_id for i in live}) == len(live),
               "duplicate task ids among live instances")
        _check(set(cluster.running) == {i.task_id for i in live},
               "backend running set diverges from store live set")
        steps.append("invariant: no duplicate launch (backend running "
                     "set == store live set)")
        return steps
    finally:
        faults.disarm()


def scenario_device_error(device: str) -> list:
    """device.solve error -> the serial cycle raises and launches nothing
    (no CPU re-solve behind the card) -> health says device-degraded with
    the pool's evidence and one incident bundle names device.solve in its
    armed faults -> the next cycle solves on the device with the healthy
    twin's placements -> health clears -> the queue drains."""
    from cook_tpu_torch import faults
    from cook_tpu_torch.models.entities import Job, JobState, Resources

    steps = []
    # healthy twin: same trace, no fault: the parity baseline
    _, store_a, _, sched_a, _ = _scheduler_rig(
        n_hosts=3, n_jobs=6, device=device, job_prefix="dev")
    clock_b, store_b, cluster_b, sched_b, jobs = _scheduler_rig(
        n_hosts=3, n_jobs=6, device=device, job_prefix="dev")
    try:
        # the healthy baseline runs BEFORE arming: the times=1 rule must
        # fire on the degraded twin's solve, not this one
        pool_a = store_a.pools["default"]
        sched_a.rank_cycle(pool_a)
        healthy = sched_a.match_cycle(pool_a)
        faults.arm(faults.FaultSchedule([faults.FaultRule(
            point=faults.DEVICE_SOLVE, mode="error", times=1)]))
        try:
            _match_once(sched_b, store_b, clock_b)
        except faults.FaultInjected:
            clock_b.ms += 1000
        else:
            raise ChaosFailure("the failed device solve did not raise")
        _check(not store_b.instances and not cluster_b.running,
               f"the failed cycle launched {len(store_b.instances)} "
               f"instances")
        steps.append("solve raised out of the serial cycle; nothing "
                     "launched, nothing re-solved on the CPU")

        verdict = sched_b.telemetry.health()
        reasons = set(verdict.get("reasons", []))
        _check("device-degraded" in reasons,
               f"expected device-degraded in {sorted(reasons)}")
        pools = [d.get("pool") for d in verdict.get("degradations", [])
                 if d.get("reason") == "device-degraded"]
        _check(pools == ["default"],
               f"device-degraded names pools {pools}, not the failed one")
        steps.append("health: device-degraded (with pool evidence)")

        # diagnosis: the ok->degraded transition must have captured an
        # incident bundle with the evidence an operator needs
        bundles = sched_b.incidents.bundles()
        _check(len(bundles) == 1,
               f"expected exactly 1 incident bundle, got {len(bundles)}")
        bundle = sched_b.incidents.get(bundles[0]["id"])
        _check("device-degraded" in bundle["reasons"],
               f"bundle reasons missing device-degraded: "
               f"{bundle['reasons']}")
        _check("traceEvents" in (bundle.get("trace") or {}),
               "incident bundle carries no chrome-trace export")
        armed = bundle.get("faults") or {}
        _check(any(r.get("point") == "device.solve"
                   for r in armed.get("rules", [])),
               f"bundle fault schedule missing device.solve: {armed}")
        steps.append(f"diagnosis: incident bundle {bundle['id']} captured "
                     f"(verdict + chrome trace + armed faults)")

        # the rule is spent: the next cycle solves on the device
        recovered = _match_once(sched_b, store_b, clock_b)
        a = {(j.uuid, o.hostname) for j, o in healthy.matched}
        b = {(j.uuid, o.hostname) for j, o in recovered.matched}
        _check(len(b) == len(jobs),
               f"recovery cycle matched {len(b)}/{len(jobs)}")
        _check(a == b, f"placements diverge from the healthy twin: "
                       f"{a ^ b}")
        steps.append(f"next cycle solved on the device with the healthy "
                     f"twin's placements ({len(b)} jobs)")

        reasons = set(sched_b.telemetry.health().get("reasons", []))
        _check("device-degraded" not in reasons,
               f"a solve on the device did not clear the reason: "
               f"{sorted(reasons)}")
        steps.append("recovery: health ok")

        # keep the pool solvable: later jobs place as they arrive
        extra = 0
        for cycle in range(2):
            more = [Job(uuid=f"dev-x{cycle}-{i}", user="u0",
                        pool="default", command="true",
                        resources=Resources(mem=100, cpus=0.5),
                        max_retries=5) for i in range(2)]
            store_b.submit_jobs(more)
            extra += len(more)
            _match_once(sched_b, store_b, clock_b)
        running = sum(1 for j in store_b.jobs.values()
                      if j.state is JobState.RUNNING)
        _check(running == len(jobs) + extra,
               f"{running}/{len(jobs) + extra} jobs running")
        steps.append(f"invariant: queue drained ({running} jobs running)")
        return steps
    finally:
        faults.disarm()


def scenario_fsync_degrade() -> list:
    """journal.fsync ERROR under the degrade-async policy -> commits
    still ack, health says journal-fsync-degraded -> disk recovers ->
    reason clears; the journal holds every acked commit."""
    from cook_tpu_torch import faults
    from cook_tpu_torch.models import persistence
    from cook_tpu_torch.rest.server import InprocessControlPlane

    steps = []
    cp = InprocessControlPlane(journal_kw={
        "fsync_policy": "degrade-async", "degraded_retry_s": 0.2}).start()
    try:
        faults.arm(faults.FaultSchedule([faults.FaultRule(
            point=faults.JOURNAL_FSYNC, mode="error")]))
        acked = _submit_jobs(cp.url, 5, "deg")
        steps.append("5 jobs acked while every fsync FAILED "
                     "(degrade-async)")
        _, _, health = _get(f"{cp.url}/debug/health")
        _check("journal-fsync-degraded" in health.get("reasons", []),
               f"expected journal-fsync-degraded in {health.get('reasons')}")
        steps.append("health: journal-fsync-degraded")

        faults.disarm()
        time.sleep(0.25)  # past degraded_retry_s: next sync re-probes
        acked += _submit_jobs(cp.url, 1, "deg-post")

        def cleared():
            _, _, h = _get(f"{cp.url}/debug/health")
            return "journal-fsync-degraded" not in h.get("reasons", [])
        _wait_until(cleared, timeout_s=5.0,
                    what="journal-fsync-degraded to clear")
        steps.append("recovery: disk probe succeeded, reason cleared")

        cp.journal.sync()
        events = persistence.read_journal(cp.journal.path)
        journaled = {e.get("data", {}).get("uuid")
                     for e in events if e.get("kind") == "job/created"}
        missing = [u for u in acked if u not in journaled]
        _check(not missing, f"acked jobs missing from the journal: "
                            f"{missing}")
        steps.append(f"invariant: all {len(acked)} acked commits on disk")
        return steps
    finally:
        faults.disarm()
        cp.stop()


def scenario_replication_lag() -> list:
    """replication.fetch dropped -> follower backs off (jittered, capped;
    reconnects counted) and the leader's health says replication-lag ->
    drop clears -> follower catches up, health ok, stores converge."""
    from cook_tpu_torch import faults
    from cook_tpu_torch.control.replication import JournalFollower
    from cook_tpu_torch.models.store import JobStore
    from cook_tpu_torch.obs.contention import ContentionParams
    from cook_tpu_torch.rest.api import ApiConfig
    from cook_tpu_torch.rest.server import InprocessControlPlane
    from cook_tpu_torch.utils.retry import RetryPolicy

    steps = []
    params = ContentionParams(replication_lag_events=5,
                              replication_ack_age_s=0.4)
    cp = InprocessControlPlane(config=ApiConfig(contention=params)).start()
    store2 = JobStore()
    follower = JournalFollower(
        store2, leader_url_fn=lambda: cp.url, self_url="http://standby",
        member_id="standby", poll_s=0.05, timeout_s=2.0, long_poll_s=0.1,
        reconnect_policy=RetryPolicy(base_s=0.05, cap_s=0.3)).start()
    try:
        _submit_jobs(cp.url, 3, "rep")
        _wait_until(lambda: store2.last_seq() == cp.store.last_seq(),
                    timeout_s=5.0, what="initial follower sync")
        steps.append("follower synced 3 jobs")

        faults.arm(faults.FaultSchedule([faults.FaultRule(
            point=faults.REPLICATION_FETCH, mode="error")]))
        _submit_jobs(cp.url, 10, "rep-lag")

        def lagging():
            _, _, h = _get(f"{cp.url}/debug/health")
            return "replication-lag" in h.get("reasons", [])
        _wait_until(lagging, timeout_s=5.0, what="replication-lag reason")
        steps.append("health: replication-lag (follower behind + silent)")
        _wait_until(lambda: follower.reconnect_attempts >= 2,
                    timeout_s=5.0, what="follower reconnect backoff")
        steps.append(f"reaction: follower backing off "
                     f"({follower.reconnect_attempts} reconnect attempts "
                     f"counted)")

        faults.disarm()
        _wait_until(lambda: store2.last_seq() == cp.store.last_seq(),
                    timeout_s=10.0, what="follower catch-up")
        _wait_until(lambda: not lagging(), timeout_s=5.0,
                    what="replication-lag to clear")
        _check(len(store2.jobs) == len(cp.store.jobs),
               f"stores diverge: {len(store2.jobs)} vs "
               f"{len(cp.store.jobs)} jobs")
        steps.append("recovery: follower caught up, stores converged, "
                     "health ok")
        return steps
    finally:
        faults.disarm()
        follower.stop()
        cp.stop()


def scenario_failover_fsync() -> list:
    """fsync fault (fail-stop) on the LEADER's journal while a durable
    follower tails it -> the failing commit errors to its client -> the
    leader "dies" -> a store recovered from the FOLLOWER's local disk
    holds every previously-acked transaction."""
    from cook_tpu_torch import faults
    from cook_tpu_torch.control.replication import JournalFollower
    from cook_tpu_torch.models import persistence
    from cook_tpu_torch.models.store import JobStore
    from cook_tpu_torch.rest.server import InprocessControlPlane

    steps = []
    follower_dir = tempfile.mkdtemp(prefix="cook-chaos-standby-")
    cp = InprocessControlPlane().start()
    store2 = JobStore()
    journal2 = persistence.attach_journal(
        store2, os.path.join(follower_dir, "journal.jsonl"))
    follower = JournalFollower(
        store2, leader_url_fn=lambda: cp.url, self_url="http://standby",
        member_id="standby", data_dir=follower_dir, journal=journal2,
        poll_s=0.05, timeout_s=2.0, long_poll_s=0.1).start()
    try:
        acked = _submit_jobs(cp.url, 5, "fo")
        _wait_until(lambda: store2.last_seq() == cp.store.last_seq(),
                    timeout_s=5.0, what="follower sync")
        steps.append("5 acked jobs replicated to the durable standby")

        # the leader's disk dies mid-fsync (the follower's own journal
        # is NOT matched by the rule — one process hosts both)
        faults.arm(faults.FaultSchedule([faults.FaultRule(
            point=faults.JOURNAL_FSYNC, mode="error",
            match={"path": cp.journal.path})]))
        status, _ = _post(f"{cp.url}/jobs", {"jobs": [{
            "uuid": "fo-doomed", "command": "true", "mem": 64,
            "cpus": 0.1}]})
        _check(status >= 500,
               f"fail-stop fsync should error the commit, got {status}")
        steps.append(f"fail-stop: commit during the fsync fault answered "
                     f"{status} (client knows it is not durable)")

        # leader crashes; promote from the follower's LOCAL copy
        cp.server.stop()
        follower.stop()
        journal2.sync()
        journal2.close()
        promoted = persistence.recover(follower_dir)
        _check(promoted is not None, "nothing recoverable on the standby")
        missing = [u for u in acked if u not in promoted.jobs]
        _check(not missing,
               f"acked txns lost across failover: {missing}")
        steps.append(f"invariant: promoted standby holds all "
                     f"{len(acked)} acked jobs")
        return steps
    finally:
        faults.disarm()
        cp.stop()
        shutil.rmtree(follower_dir, ignore_errors=True)


def scenario_wedged_shard() -> list:
    """journal.fsync delay on ONE shard's segment -> only that shard's
    keys degrade (slow-path commits), other shards' commit-ack p99 stays
    within SLO, health names the wedged shard -> a leader failover
    mid-drill (recover from the per-shard segments) loses no acked txn
    -> fault clears -> the wedged shard serves at full speed again."""
    import statistics as _stats

    from cook_tpu_torch import faults
    from cook_tpu_torch.obs.contention import ContentionParams
    from cook_tpu_torch.rest.api import ApiConfig
    from cook_tpu_torch.rest.server import InprocessControlPlane
    from cook_tpu_torch.shard import ShardRouter
    from cook_tpu_torch.shard import journal as shard_journal

    steps = []
    n_shards = 4
    router = ShardRouter(n_shards)
    pools = router.pools_for_distinct_shards()
    params = ContentionParams(
        fsync_stall_s=0.25, lock_min_acquisitions=1_000_000_000)
    cp = InprocessControlPlane(
        shards=n_shards, pools=tuple(pools),
        config=ApiConfig(contention=params)).start()
    wedged = 2
    wedged_pool = pools[wedged]
    delay_s = 0.3
    slo_ms = 150.0
    acked: list = []

    def submit_timed(pool: str, uuid: str) -> float:
        t0 = time.perf_counter()
        status, _ = _post(f"{cp.url}/jobs", {"jobs": [{
            "uuid": uuid, "command": "true", "mem": 64, "cpus": 0.1,
            "pool": pool}]})
        _check(status == 201, f"submit {uuid} -> {status}")
        acked.append(uuid)
        return (time.perf_counter() - t0) * 1000

    try:
        faults.arm(faults.FaultSchedule([faults.FaultRule(
            point=faults.JOURNAL_FSYNC, mode="delay", delay_s=delay_s,
            match={"path": cp.journals[wedged].path})]))
        walls: dict[str, list] = {p: [] for p in pools}
        for i in range(6):
            for p in pools:
                walls[p].append(submit_timed(p, f"wedge-{p}-{i:02d}"))
        wedged_p99 = max(walls[wedged_pool])
        other_p99 = max(max(walls[p]) for p in pools
                        if p != wedged_pool)
        _check(wedged_p99 >= delay_s * 1000 * 0.8,
               f"wedged shard commits were not slowed "
               f"({wedged_p99:.0f} ms)")
        _check(other_p99 < slo_ms,
               f"healthy shards degraded too: worst p99 "
               f"{other_p99:.0f} ms (SLO {slo_ms:.0f} ms)")
        healthy_p50 = _stats.median(
            w for p in pools if p != wedged_pool for w in walls[p])
        steps.append(
            f"shard {wedged} wedged ({delay_s * 1000:.0f} ms fsync "
            f"delay): its commits take {wedged_p99:.0f} ms while other "
            f"shards stay at p50 {healthy_p50:.1f} ms / worst "
            f"{other_p99:.0f} ms — blast radius is ONE shard")

        _, _, health = _get(f"{cp.url}/debug/health")
        stalls = [d for d in health.get("degradations", [])
                  if d.get("reason") == "fsync-stall"]
        _check(any(d.get("shard") == wedged for d in stalls),
               f"health does not attribute the stall to shard "
               f"{wedged}: {stalls}")
        _check(all(d.get("shard") in (None, wedged) for d in stalls),
               f"healthy shards flagged too: {stalls}")
        steps.append(f"health: fsync-stall names shard {wedged} (and "
                     f"only it)")

        # leader failover MID-DRILL: a promoted process recovers from
        # the per-shard segments — every acked txn must be there
        recovered = shard_journal.recover_sharded(cp.data_dir, n_shards)
        _check(recovered is not None, "nothing recoverable on disk")
        missing = [u for u in acked if u not in recovered.jobs]
        _check(not missing,
               f"acked txns lost across mid-drill failover: {missing}")
        steps.append(f"failover mid-drill: recovery from the segment "
                     f"layout holds all {len(acked)} acked jobs")

        faults.disarm()
        # roll the wedged segment's recent-fsync window (64 entries)
        # with clean commits, then health must clear
        for i in range(70):
            submit_timed(wedged_pool, f"wedge-post-{i:03d}")

        def cleared():
            _, _, h = _get(f"{cp.url}/debug/health")
            return "fsync-stall" not in h.get("reasons", [])
        _wait_until(cleared, timeout_s=20.0, what="fsync-stall to clear")
        fast = submit_timed(wedged_pool, "wedge-final")
        _check(fast < slo_ms,
               f"wedged shard still slow after recovery ({fast:.0f} ms)")
        for uuid in acked:
            status, _, _ = _get(f"{cp.url}/jobs/{uuid}")
            _check(status == 200, f"acked job {uuid} lost ({status})")
        steps.append(f"recovery: shard {wedged} back to "
                     f"{fast:.1f} ms commits, health ok, all "
                     f"{len(acked)} acked jobs present")
        return steps
    finally:
        faults.disarm()
        cp.stop()


def scenario_killed_worker() -> list:
    """SIGKILL one shard-group WORKER PROCESS mid-traffic -> only that
    group's keys degrade (the other worker keeps acking submits at 201
    throughout) -> the supervisor promotes a standby, which adopts the
    dead worker's journal segments -> the killed group serves again and
    EVERY acked submit — including ones acked moments before the kill —
    reads back through the front end.  The multi-process analog of
    wedged-shard: process death instead of a wedged fsync, standby
    adoption instead of in-place recovery."""
    import signal as _signal

    from cook_tpu_torch.mp.supervisor import MpRuntime

    steps = []
    n_groups = 2
    victim = 0
    runtime = MpRuntime(n_groups=n_groups, standbys=1, poll_s=0.3)
    acked: dict[str, list] = {}
    try:
        pools = [p for p in runtime.pools if p != "default"]
        url = runtime.url

        def submit(pool: str, uuid: str, timeout: float = 10.0) -> int:
            status, _ = _post(f"{url}/jobs", {"jobs": [{
                "uuid": uuid, "command": "true", "mem": 64,
                "cpus": 0.1, "pool": pool}]}, timeout=timeout)
            if status == 201:
                acked.setdefault(pool, []).append(uuid)
            return status

        # baseline: both groups acking
        for i in range(4):
            for pool in pools:
                _check(submit(pool, f"kw-{pool}-{i:02d}") == 201,
                       f"baseline submit to {pool} failed")
        victim_pool, healthy_pool = pools[victim], pools[1 - victim]
        baseline = sum(len(v) for v in acked.values())
        steps.append(f"baseline: {baseline} submits acked across "
                     f"{n_groups} worker processes")

        runtime.supervisor.kill_worker(victim, _signal.SIGKILL)

        # blast radius: the healthy group keeps acking while the
        # victim's keys fail (fast 5xx via breaker/dead-map, or a
        # transport error) until the standby adopts
        degraded = False
        for i in range(20):
            _check(submit(healthy_pool, f"kw-live-{i:02d}",
                          timeout=5.0) == 201,
                   f"healthy group stopped acking after the kill "
                   f"(submit {i})")
            status = submit(victim_pool, f"kw-dead-{i:02d}",
                            timeout=3.0)
            if status != 201:
                degraded = True
            time.sleep(0.05)
        _check(degraded, "killing a worker degraded nothing — the "
                         "drill saw no blast radius at all")
        steps.append(f"SIGKILL group {victim}: only pool "
                     f"{victim_pool!r} degraded; {healthy_pool!r} "
                     f"acked every submit throughout")

        # supervisor: standby adopts the dead worker's segments
        def adopted():
            _, _, shards = _get(f"{url}/debug/shards")
            groups = shards.get("groups", [])
            return (shards.get("map_seq", 0) >= 3
                    and all(e["alive"] for e in groups) and shards)
        shards = _wait_until(adopted, timeout_s=60.0,
                             what="standby adoption in the route map")
        steps.append(f"standby adopted group {victim}'s journal "
                     f"segments (map_seq {shards['map_seq']})")

        # diagnosis: the fleet poller saw the victim's ok->degraded edge
        # and captured a FEDERATED incident through the front end's
        # recorder — one bundle embedding the 2PC decision-log tail, the
        # breaker states, and the route map (obs/distributed.py)
        def federated_bundle():
            status, _, index = _get(f"{url}/debug/incidents")
            if status != 200:
                return None
            fed = [b for b in index.get("incidents", [])
                   if b.get("trigger") == "fleet-peer"]
            return fed[-1] if fed else None
        summary = _wait_until(federated_bundle, timeout_s=30.0,
                              interval_s=0.3,
                              what="a fleet-peer incident bundle at "
                                   "the front end")
        status, _, bundle = _get(f"{url}/debug/incidents/{summary['id']}")
        _check(status == 200,
               f"federated bundle {summary['id']} not served by id")
        for evidence in ("decision_log", "breakers", "route_map"):
            _check(isinstance(bundle.get(evidence), dict)
                   and "error" not in bundle[evidence],
                   f"federated bundle missing {evidence} evidence: "
                   f"{bundle.get(evidence)}")
        _check(bundle["decision_log"].get("records") is not None,
               "decision_log evidence carries no records field")
        _check(bundle["route_map"].get("groups"),
               "route_map evidence carries no groups")
        steps.append(f"diagnosis: federated incident {summary['id']} "
                     f"(trigger fleet-peer) embeds decision-log tail, "
                     f"breaker states, and the route map")

        # recovery: the victim pool acks again...
        def victim_acks():
            return submit(victim_pool, f"kw-post-{int(time.monotonic()*1e3)%100000}",
                          timeout=5.0) == 201
        _wait_until(victim_acks, timeout_s=30.0, interval_s=0.3,
                    what="the adopted group to ack submits")
        # ...and NO acked txn was lost: every 201 ever returned reads
        # back through the front end, including pre-kill acks whose
        # only durable copy was the dead worker's journal segment
        missing = []
        for pool, uuids in acked.items():
            for uuid in uuids:
                status, _, _ = _get(f"{url}/jobs/{uuid}")
                if status != 200:
                    missing.append(uuid)
        _check(not missing,
               f"acked submits lost across worker death: {missing}")
        total = sum(len(v) for v in acked.values())
        steps.append(f"recovery: adopted group acks; all {total} acked "
                     f"submits (both groups) read back — no acked txn "
                     f"lost")
        return steps
    finally:
        runtime.stop()


SCENARIOS = {
    "fsync-stall-sheds": scenario_fsync_stall_sheds,
    "launch-breaker": scenario_launch_breaker,
    "device-error": scenario_device_error,
    "fsync-degrade": scenario_fsync_degrade,
    "replication-lag": scenario_replication_lag,
    "failover-fsync": scenario_failover_fsync,
    "wedged-shard": scenario_wedged_shard,
    "killed-worker": scenario_killed_worker,
}

# the fast set ci_checks runs on every build (the original trio plus
# the sharded control plane's blast-radius drill and the mp runtime's
# worker-death drill)
SMOKE = ("fsync-stall-sheds", "launch-breaker", "device-error",
         "wedged-shard", "killed-worker")

# the scenarios that drive the scheduler, and so take the device
DEVICE_SCENARIOS = ("launch-breaker", "device-error")


def run_scenario(name: str, device: str = "cuda") -> ScenarioResult:
    from cook_tpu_torch import faults

    fn = SCENARIOS[name]
    t0 = time.monotonic()
    try:
        steps = fn(device) if name in DEVICE_SCENARIOS else fn()
        return ScenarioResult(name=name, passed=True,
                              seconds=time.monotonic() - t0, steps=steps)
    except Exception as e:  # noqa: BLE001 — a scenario failure is data
        return ScenarioResult(name=name, passed=False,
                              seconds=time.monotonic() - t0,
                              error=f"{type(e).__name__}: {e}")
    finally:
        faults.disarm()  # never leak an armed schedule across scenarios


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="fault-injection chaos scenarios with recovery "
                    "invariants")
    parser.add_argument("--smoke", action="store_true",
                        help=f"run the fast CI set: {', '.join(SMOKE)}")
    parser.add_argument("--scenario", action="append", default=[],
                        help="run one scenario by name (repeatable)")
    parser.add_argument("--list", action="store_true")
    parser.add_argument("--json", action="store_true",
                        help="machine-readable results on stdout")
    parser.add_argument("--device", default="cuda",
                        help="the scheduler scenarios' device: cuda "
                             "(default) or cpu")
    args = parser.parse_args(argv)

    if args.list:
        for name in SCENARIOS:
            tag = " [smoke]" if name in SMOKE else ""
            print(f"{name}{tag}")
        return 0
    if args.scenario:
        unknown = [s for s in args.scenario if s not in SCENARIOS]
        if unknown:
            print(f"chaos: unknown scenario(s): {', '.join(unknown)}",
                  file=sys.stderr)
            return 2
        selected = args.scenario
    elif args.smoke:
        selected = list(SMOKE)
    else:
        selected = list(SCENARIOS)

    results = []
    for name in selected:
        print(f"chaos: === {name} ===", flush=True)
        result = run_scenario(name, args.device)
        results.append(result)
        if result.passed:
            for step in result.steps:
                print(f"chaos:   - {step}")
            print(f"chaos: {name}: PASS ({result.seconds:.1f}s)",
                  flush=True)
        else:
            print(f"chaos: {name}: FAIL ({result.error})", flush=True)
    if args.json:
        print(json.dumps([r.to_dict() for r in results], indent=1))
    failed = [r.name for r in results if not r.passed]
    if failed:
        print(f"chaos: FAILED: {', '.join(failed)}")
        return 1
    print(f"chaos: all {len(results)} scenarios passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
