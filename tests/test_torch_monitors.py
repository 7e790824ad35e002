"""The scheduler's host-side duties in `cook_tpu_torch` against `cook_tpu`
on the CPU: tests/test_monitors.py (progress aggregation, heartbeats,
monitor gauges, sandbox publishing, the passport, the lingering and
straggler killers), test_plugins.py (submission plugins through the REST
layer, launch filters with their TTL cache, completion handlers, plugin
loading, the pool mover) and test_optimizer.py, each on both packages
(`P` over `ref` / `port`); and the four task-lifecycle monitors
(`kill_lingering_tasks`, `kill_stragglers`, `kill_cancelled_tasks`,
`reconcile`) deciding as the reference's do on the same store."""
import logging
from types import SimpleNamespace

import pytest
import requests
import torch

from cook_tpu.cluster import mock as ref_mock
from cook_tpu.models import entities as ref_ent
from cook_tpu.models import store as ref_store
from cook_tpu.rest import api as ref_api
from cook_tpu.rest import server as ref_server
from cook_tpu.scheduler import core as ref_core
from cook_tpu.scheduler import heartbeat as ref_heartbeat
from cook_tpu.scheduler import monitor as ref_monitor
from cook_tpu.scheduler import optimizer as ref_optimizer
from cook_tpu.scheduler import plugins as ref_plugins
from cook_tpu.scheduler import progress as ref_progress
from cook_tpu.scheduler import sandbox as ref_sandbox
from cook_tpu.utils import logging as ref_logging
from cook_tpu.utils import metrics as ref_metrics
from cook_tpu_torch.cluster import mock as port_mock
from cook_tpu_torch.models import entities as port_ent
from cook_tpu_torch.models import store as port_store
from cook_tpu_torch.rest import api as port_api
from cook_tpu_torch.rest import server as port_server
from cook_tpu_torch.scheduler import core as port_core
from cook_tpu_torch.scheduler import heartbeat as port_heartbeat
from cook_tpu_torch.scheduler import monitor as port_monitor
from cook_tpu_torch.scheduler import optimizer as port_optimizer
from cook_tpu_torch.scheduler import plugins as port_plugins
from cook_tpu_torch.scheduler import progress as port_progress
from cook_tpu_torch.scheduler import sandbox as port_sandbox
from cook_tpu_torch.utils import logging as port_logging
from cook_tpu_torch.utils import metrics as port_metrics
from tests.conftest import FakeClock

torch.set_num_threads(1)

REF = SimpleNamespace(
    name="ref", pkg="cook_tpu", mock=ref_mock, ent=ref_ent, store=ref_store,
    api=ref_api, server=ref_server, core=ref_core, heartbeat=ref_heartbeat,
    monitor=ref_monitor, optimizer=ref_optimizer, plugins=ref_plugins,
    progress=ref_progress, sandbox=ref_sandbox, logging=ref_logging,
    metrics=ref_metrics, kw={})
PORT = SimpleNamespace(
    name="port", pkg="cook_tpu_torch", mock=port_mock, ent=port_ent,
    store=port_store, api=port_api, server=port_server, core=port_core,
    heartbeat=port_heartbeat, monitor=port_monitor, optimizer=port_optimizer,
    plugins=port_plugins, progress=port_progress, sandbox=port_sandbox,
    logging=port_logging, metrics=port_metrics, kw={"device": "cpu"})
PKGS = pytest.mark.parametrize("P", [REF, PORT], ids=["ref", "port"])
H = {"X-Cook-Requesting-User": "u"}
TIMEOUT_S = 30


def mk_job(P, user="alice", pool="default", mem=100.0, cpus=1.0, gpus=0.0,
           priority=50, max_retries=1, uuid=None, **kw):
    return P.ent.Job(uuid=uuid or P.ent.new_uuid(), user=user, pool=pool,
                     priority=priority, max_retries=max_retries,
                     resources=P.ent.Resources(mem=mem, cpus=cpus, gpus=gpus),
                     command="true", **kw)


def setup(P, n_hosts=2, cpus=8.0, plugins=None):
    clock = FakeClock()
    store = P.store.JobStore(clock=clock)
    store.set_pool(P.ent.Pool(name="default"))
    cluster = P.mock.MockCluster(
        "mock",
        [P.mock.MockHost(node_id=f"h{i}", hostname=f"h{i}", mem=4000,
                         cpus=cpus) for i in range(n_hosts)],
        clock=clock)
    scheduler = P.core.Scheduler(store, [cluster], plugins=plugins, **P.kw)
    return clock, store, cluster, scheduler


def run_job(store, scheduler, job):
    store.submit_jobs([job])
    pool = store.pools["default"]
    scheduler.rank_cycle(pool)
    scheduler.match_cycle(pool)
    return store.job_instances(job.uuid)[-1]


# ------------------------------------------------ tests/test_monitors.py


@PKGS
def test_progress_newest_sequence_wins_and_cap(P):
    clock, store, cluster, scheduler = setup(P)
    inst = run_job(store, scheduler, mk_job(P))
    agg = P.progress.ProgressAggregator(store)
    assert agg.handle(P.progress.ProgressUpdate(inst.task_id, 2, 40,
                                                "later"))
    assert not agg.handle(P.progress.ProgressUpdate(inst.task_id, 1, 99,
                                                    "stale"))
    assert agg.publish() == 1
    assert store.instances[inst.task_id].progress == 40
    capped = P.progress.ProgressAggregator(store, max_pending=2)
    assert capped.handle(P.progress.ProgressUpdate("a", 1, 1))
    assert capped.handle(P.progress.ProgressUpdate("b", 1, 1))
    assert not capped.handle(P.progress.ProgressUpdate("c", 1, 1))
    assert capped.dropped == 1
    assert capped.handle(P.progress.ProgressUpdate("a", 2, 2))


@PKGS
def test_silent_task_killed_mea_culpa(P):
    clock, store, cluster, scheduler = setup(P)
    job = mk_job(P, max_retries=2)
    inst = run_job(store, scheduler, job)
    killed = []
    hb = P.heartbeat.HeartbeatMonitor(store, killed.append,
                                      timeout_ms=60_000)
    hb.track(inst.task_id)
    clock.advance(30_000)
    hb.notify(inst.task_id)
    assert hb.check() == []
    clock.advance(61_000)
    assert hb.check() == [inst.task_id]
    assert killed == [inst.task_id]
    assert store.jobs[job.uuid].state == P.ent.JobState.WAITING


@PKGS
def test_monitor_gauges(P):
    clock, store, cluster, scheduler = setup(P, n_hosts=1, cpus=4.0)
    store.set_share(P.ent.Share(user=P.ent.DEFAULT_USER, pool="default",
                                resources=P.ent.Resources(mem=2000, cpus=4,
                                                          gpus=1)))
    for _ in range(2):
        run_job(store, scheduler, mk_job(P, user="hog", cpus=2))
    store.submit_jobs([mk_job(P, user="starved", cpus=2, mem=300)])
    stats = P.monitor.collect_pool_stats(store, "default")
    assert (stats.running_jobs, stats.waiting_jobs, stats.starved_users,
            stats.used.cpus) == (2, 1, 1, 4)
    labels = {"pool": "default"}
    g = P.metrics.global_registry.gauge
    assert g("monitor.running_jobs").value(labels) == 2
    assert g("monitor.waiting_jobs").value(labels) == 1
    assert g("monitor.starved_users").value(labels) == 1
    assert g("monitor.used_cpus").value(labels) == 4
    assert g("monitor.waiting_mem").value(labels) == 300
    text = P.metrics.global_registry.render_prometheus()
    assert 'cook_monitor_waiting_mem{pool="default"} 300' in text
    assert "# HELP cook_monitor_starved_users" in text
    store.set_pool(P.ent.Pool(name="batch"))
    store.submit_jobs([mk_job(P, user="u2", pool="batch")])
    every = P.monitor.collect_all(store)
    assert set(every) >= {"default", "batch"}
    assert every["batch"].waiting_jobs == 1


@PKGS
def test_starvation_stats_and_commit_ack(P):
    clock, store, cluster, scheduler = setup(P, n_hosts=1, cpus=1.0)
    store.submit_jobs([mk_job(P, user="a", uuid="j-a")])
    clock.advance(5000)
    store.submit_jobs([mk_job(P, user="b", uuid="j-b")])
    clock.advance(1000)
    stats = P.monitor.starvation_stats(store, "default")
    assert stats["oldest_job"] == "j-a"
    assert stats["oldest_age_s"] == 6.0
    assert stats["user_max_wait_s"] == {"a": 6.0, "b": 1.0}
    assert (stats["worst_user"], stats["worst_user_wait_s"]) == ("a", 6.0)
    hist = P.metrics.global_registry.histogram(
        "job.latency.submit_commit_ack")
    before = hist.count()
    P.monitor.observe_commit_ack(0.25)
    assert hist.count() == before + 1


@PKGS
def test_lifecycle_tracker_observes_the_job_latencies(P):
    clock, store, cluster, scheduler = setup(P)
    hist = {name: P.metrics.global_registry.histogram(f"job.latency.{name}")
            for name in ("submit_to_matched", "end_to_end")}
    before = {n: h.count({"pool": "default"}) for n, h in hist.items()}
    job = mk_job(P)
    store.submit_jobs([job])
    clock.advance(2000)
    scheduler.rank_cycle(store.pools["default"])
    scheduler.match_cycle(store.pools["default"])
    cluster.advance_to(clock() + 10_000_000)
    after = {n: h.count({"pool": "default"}) for n, h in hist.items()}
    assert after == {n: c + 1 for n, c in before.items()}
    # the effect gate: a passive scheduler observes nothing
    scheduler.active = False
    run_job(store, scheduler, mk_job(P))
    assert hist["submit_to_matched"].count({"pool": "default"}) == \
        after["submit_to_matched"]


@PKGS
def test_sandbox_publisher_batches(P):
    clock, store, cluster, scheduler = setup(P)
    inst = run_job(store, scheduler, mk_job(P))
    pub = P.sandbox.SandboxPublisher(store)
    pub.record_sandbox(inst.task_id, "/sandbox/t1")
    pub.record_exit_code(inst.task_id, 0)
    assert pub.pending_count == 1
    assert pub.publish() == 1
    assert store.instances[inst.task_id].sandbox_directory == "/sandbox/t1"
    assert store.instances[inst.task_id].exit_code == 0


@PKGS
def test_passport_audit_events(P, caplog):
    clock, store, cluster, scheduler = setup(P)
    P.logging.attach_passport(store)
    logger = f"{P.pkg}.passport"
    with caplog.at_level(logging.INFO, logger=logger):
        inst = run_job(store, scheduler, mk_job(P))
        store.update_instance_state(inst.task_id,
                                    P.ent.InstanceStatus.SUCCESS, 1000)
    joined = "\n".join(r.message for r in caplog.records
                       if r.name == logger)
    for event in ("job-created", "job-launched", "instance-completed",
                  "job-completed"):
        assert event in joined


@PKGS
def test_rest_heartbeats_feed_the_monitor(P):
    clock, store, cluster, scheduler = setup(P)
    killed = []
    scheduler.heartbeats = P.heartbeat.HeartbeatMonitor(
        store, killed.append, timeout_ms=60_000)
    srv = P.server.ServerThread(P.api.CookApi(store, scheduler,
                                              P.api.ApiConfig())).start()
    try:
        inst = run_job(store, scheduler, mk_job(P, max_retries=3))
        r = requests.post(f"{srv.url}/heartbeat/{inst.task_id}", headers=H,
                          timeout=TIMEOUT_S)
        assert r.status_code == 202
        r = requests.post(f"{srv.url}/heartbeat/nope", headers=H,
                          timeout=TIMEOUT_S)
        assert r.status_code == 404
        clock.advance(61_000)
        assert scheduler.heartbeats.check() == [inst.task_id]
        assert killed == [inst.task_id]
    finally:
        srv.stop()


# ----------------------------- the four task-lifecycle monitors


@PKGS
def test_lingering_task_killed_at_max_runtime(P):
    clock, store, cluster, scheduler = setup(P)
    job = mk_job(P, max_runtime_ms=50_000, max_retries=5)
    inst = run_job(store, scheduler, job)
    short = run_job(store, scheduler, mk_job(P, max_runtime_ms=500_000))
    clock.advance(60_000)
    assert scheduler.kill_lingering_tasks(clock()) == [inst.task_id]
    assert store.instances[inst.task_id].reason_code == 2003
    assert inst.task_id not in cluster.running
    assert short.task_id in cluster.running
    assert scheduler.kill_lingering_tasks(clock()) == []


@PKGS
def test_straggler_killed_by_quantile_rule(P):
    clock, store, cluster, scheduler = setup(P, n_hosts=4)
    group = P.ent.Group(
        uuid="g1", straggler_handling=P.ent.StragglerHandling(
            type="quantile-deviation", quantile=0.5, multiplier=2.0))
    jobs = [mk_job(P, group_uuid="g1", max_retries=5) for _ in range(4)]
    store.submit_jobs(jobs, [group])
    scheduler.rank_cycle(store.pools["default"])
    scheduler.match_cycle(store.pools["default"])
    insts = [store.job_instances(j.uuid)[0] for j in jobs]
    assert scheduler.kill_stragglers(clock()) == []   # < 2 completions
    for inst in insts[:3]:
        clock.advance(10_000)
        store.update_instance_state(inst.task_id,
                                    P.ent.InstanceStatus.SUCCESS,
                                    "normal-exit")
    assert scheduler.kill_stragglers(clock()) == []
    clock.advance(100_000)
    assert scheduler.kill_stragglers(clock()) == [insts[3].task_id]
    assert store.instances[insts[3].task_id].reason_code == 2004


@PKGS
def test_cancelled_tasks_are_killed(P):
    clock, store, cluster, scheduler = setup(P)
    a = run_job(store, scheduler, mk_job(P, max_retries=3))
    b = run_job(store, scheduler, mk_job(P, max_retries=3))
    store.mark_instance_cancelled(a.task_id)
    assert scheduler.kill_cancelled_tasks() == [a.task_id]
    assert store.instances[a.task_id].status == P.ent.InstanceStatus.FAILED
    assert a.task_id not in cluster.running
    assert b.task_id in cluster.running
    assert scheduler.kill_cancelled_tasks() == []


@PKGS
def test_reconcile_fails_tasks_the_backend_lost(P):
    clock, store, cluster, scheduler = setup(P)
    a = run_job(store, scheduler, mk_job(P, max_retries=3))
    b = run_job(store, scheduler, mk_job(P, max_retries=3))
    assert scheduler.reconcile() == []
    del cluster.running[a.task_id]     # the backend forgot it
    assert scheduler.reconcile() == [a.task_id]
    inst = store.instances[a.task_id]
    assert inst.status == P.ent.InstanceStatus.FAILED
    assert store.jobs[a.job_uuid].state == P.ent.JobState.WAITING
    assert store.instances[b.task_id].status == \
        P.ent.InstanceStatus.RUNNING


def _monitor_script(P):
    """One store through every monitor; each one's decisions, by index of
    creation (task ids carry random uuids)."""
    clock, store, cluster, scheduler = setup(P, n_hosts=4, cpus=16.0)
    group = P.ent.Group(uuid="g", straggler_handling=P.ent.StragglerHandling(
        type="quantile-deviation", quantile=0.5, multiplier=1.5))
    jobs = [mk_job(P, uuid=f"j{i}", max_retries=4,
                   max_runtime_ms=(40_000 if i % 3 == 0 else 10**9),
                   group_uuid="g" if i < 6 else None) for i in range(12)]
    store.submit_jobs(jobs, [group])
    scheduler.rank_cycle(store.pools["default"])
    scheduler.match_cycle(store.pools["default"])
    order = {store.job_instances(f"j{i}")[0].task_id: i for i in range(12)}
    decisions = []
    for step in range(6):
        clock.advance(9_000)
        if step == 1:
            for i in (1, 2):
                store.update_instance_state(
                    store.job_instances(f"j{i}")[0].task_id,
                    P.ent.InstanceStatus.SUCCESS, "normal-exit")
        if step == 2:
            store.mark_instance_cancelled(
                store.job_instances("j7")[0].task_id)
        if step == 3:
            del cluster.running[store.job_instances("j8")[0].task_id]
        decisions.append((
            sorted(order[t] for t in scheduler.kill_lingering_tasks(clock())),
            sorted(order[t] for t in scheduler.kill_stragglers(clock())),
            sorted(order[t] for t in scheduler.kill_cancelled_tasks()),
            sorted(order[t] for t in scheduler.reconcile()),
        ))
    reasons = {i: [inst.reason_code for inst in
                   store.job_instances(f"j{i}")] for i in range(12)}
    return decisions, reasons


def test_monitors_decide_as_the_reference():
    ref = _monitor_script(REF)
    port = _monitor_script(PORT)
    assert port == ref
    decisions, _ = ref
    assert any(d[0] for d in decisions) and any(d[1] for d in decisions)
    assert any(d[2] for d in decisions) and any(d[3] for d in decisions)


# ------------------------------------------------ tests/test_plugins.py


class RejectBigJobs:
    """A submission validator either package loads: its result is read
    by its `accepted` and `message` only."""

    def check_job_submission(self, spec, user, pool):
        if float(spec.get("mem", 0)) > 1000:
            return SimpleNamespace(accepted=False,
                                   message="too big for this cluster")
        return SimpleNamespace(accepted=True, message="")


class AddLabel:
    def modify_job(self, spec, user, pool):
        labels = dict(spec.get("labels", {}))
        labels["injected"] = "yes"
        return {**spec, "labels": labels}


class HoldUser:
    def __init__(self, P, user="held"):
        self.P = P
        self.user = user
        self.calls = 0

    def check_job_launch(self, job):
        self.calls += 1
        if job.user == self.user:
            return self.P.plugins.PluginResult(False, "held")
        return self.P.plugins.PluginResult(True)


class RecordCompletions:
    def __init__(self):
        self.seen = []

    def on_instance_completion(self, job, instance):
        self.seen.append((job.uuid, instance.status.value))


@PKGS
def test_submission_plugins_via_api(P):
    store = P.store.JobStore(clock=FakeClock())
    store.set_pool(P.ent.Pool(name="default"))
    plugins = P.plugins.PluginRegistry()
    plugins.submission_validators.append(RejectBigJobs())
    plugins.submission_modifiers.append(AddLabel())
    srv = P.server.ServerThread(P.api.CookApi(store, None, P.api.ApiConfig(),
                                              plugins)).start()
    try:
        r = requests.post(f"{srv.url}/jobs", json={"jobs": [
            {"command": "x", "mem": 5000}]}, headers=H, timeout=TIMEOUT_S)
        assert r.status_code == 400 and "too big" in r.json()["error"]
        r = requests.post(f"{srv.url}/jobs", json={"jobs": [
            {"command": "x", "mem": 100}]}, headers=H, timeout=TIMEOUT_S)
        assert r.status_code == 201
        uuid = r.json()["jobs"][0]
        job = requests.get(f"{srv.url}/jobs/{uuid}", headers=H,
                           timeout=TIMEOUT_S).json()
        assert job["labels"]["injected"] == "yes"
    finally:
        srv.stop()


@PKGS
def test_launch_filter_holds_jobs_with_cache(P):
    holder = HoldUser(P)
    plugins = P.plugins.PluginRegistry()
    plugins.launch_filters.append(holder)
    clock, store, cluster, scheduler = setup(P, n_hosts=1, plugins=plugins)
    held = mk_job(P, user="held")
    free = mk_job(P, user="free")
    store.submit_jobs([held, free])
    pool = store.pools["default"]
    scheduler.rank_cycle(pool)
    matched = {j.uuid for j, _ in scheduler.match_cycle(pool).matched}
    assert free.uuid in matched and held.uuid not in matched
    calls_before = holder.calls
    scheduler.rank_cycle(pool)
    scheduler.match_cycle(pool)
    assert holder.calls == calls_before     # cached inside the TTL
    clock.advance(70_000)
    scheduler.rank_cycle(pool)
    scheduler.match_cycle(pool)
    assert holder.calls > calls_before


@PKGS
def test_completion_handler_fires_only_when_active(P):
    recorder = RecordCompletions()
    plugins = P.plugins.PluginRegistry()
    plugins.completion_handlers.append(recorder)
    clock, store, cluster, scheduler = setup(P, n_hosts=1, plugins=plugins)
    job = mk_job(P)
    run_job(store, scheduler, job)
    cluster.advance_to(10_000_000)
    assert recorder.seen == [(job.uuid, "success")]
    scheduler.active = False
    other = mk_job(P)
    run_job(store, scheduler, other)
    cluster.advance_to(20_000_000)
    assert recorder.seen == [(job.uuid, "success")]


@PKGS
def test_load_plugin_and_registry_from_config(P):
    plugin = P.plugins.load_plugin(
        f"{P.pkg}.scheduler.plugins:AttributePoolSelector")
    assert plugin.select_pool({"pool": "x"}, "default") == "x"
    assert plugin.select_pool({}, "default") == "default"
    fn = P.plugins.load_plugin("tests.test_torch_monitors.RecordCompletions")
    assert type(fn).__name__ == "RecordCompletions"
    registry = P.plugins.registry_from_config({
        "submission_validators": ["tests.test_torch_monitors:RejectBigJobs"],
        "pool_selector": f"{P.pkg}.scheduler.plugins:AttributePoolSelector",
    })
    assert type(registry.submission_validators[0]).__name__ == \
        "RejectBigJobs"
    assert registry.validate_submission({"mem": 5000}, "u", "p").accepted \
        is False


@PKGS
def test_pool_mover_deterministic_rollout(P):
    mover = P.plugins.PoolMoverAdjuster({
        "default": {"destination_pool": "beta",
                    "users": {"alice": {"portion": 0.5}}}})
    jobs = [mk_job(P, user="alice", uuid=f"job-{i}") for i in range(200)]
    moved = [mover.adjust_job(j).pool == "beta" for j in jobs]
    assert 60 < sum(moved) < 140
    assert [mover.adjust_job(j).pool for j in jobs] == \
        [mover.adjust_job(j).pool for j in jobs]
    assert mover.adjust_job(mk_job(P, user="bob")).pool == "default"
    assert mover.adjust_job(mk_job(P, user="alice",
                                   pool="gamma")).pool == "gamma"
    all_in = P.plugins.PoolMoverAdjuster({"default": {
        "destination_pool": "beta", "users": {"alice": {"portion": 1.0}}}})
    assert all(all_in.adjust_job(j).pool == "beta" for j in jobs)


def test_pool_mover_buckets_equal_the_reference():
    def buckets(P):
        mover = P.plugins.PoolMoverAdjuster({"default": {
            "destination_pool": "beta",
            "users": {"alice": {"portion": 0.3}}}})
        return [mover.adjust_job(mk_job(P, user="alice",
                                        uuid=f"job-{i}")).pool
                for i in range(300)]

    assert buckets(PORT) == buckets(REF)


@PKGS
def test_pool_mover_through_rest_submission(P):
    store = P.store.JobStore(clock=FakeClock())
    store.set_pool(P.ent.Pool(name="default"))
    store.set_pool(P.ent.Pool(name="beta"))
    plugins = P.plugins.registry_from_config({
        "pool_mover": {"default": {"destination_pool": "beta",
                                   "users": {"u": {"portion": 1.0}}}}})
    srv = P.server.ServerThread(P.api.CookApi(store, None, P.api.ApiConfig(),
                                              plugins)).start()
    try:
        r = requests.post(f"{srv.url}/jobs", json={"jobs": [
            {"command": "x", "mem": 100}]}, headers=H, timeout=TIMEOUT_S)
        assert r.status_code == 201
        assert store.jobs[r.json()["jobs"][0]].pool == "beta"
        del store.pools["beta"]
        r = requests.post(f"{srv.url}/jobs", json={"jobs": [
            {"command": "x", "mem": 100}]}, headers=H, timeout=TIMEOUT_S)
        assert r.status_code == 201
        assert store.jobs[r.json()["jobs"][0]].pool == "default"
    finally:
        srv.stop()


# ---------------------------------------------- tests/test_optimizer.py


@PKGS
def test_optimizer_cycle_shape_and_validation(P):
    cycle = P.optimizer.OptimizerCycle()
    out = cycle.run([], [], {})
    assert out == {0: {"suggested-matches": {}, "suggested-purchases": {}}}
    assert cycle.latest_schedule == out

    class Bad(P.optimizer.NoOpOptimizer):
        def produce_schedule(self, *a):
            return {"not-an-int": {}}

    with pytest.raises(ValueError):
        P.optimizer.OptimizerCycle(optimizer=Bad()).run([], [], {})


@PKGS
def test_backlog_purchase_sizing(P):
    class Feed(P.optimizer.NoOpHostFeed):
        def get_available_host_info(self):
            return [P.optimizer.HostInfo("small", count=100, cpus=8,
                                         mem=16000),
                    P.optimizer.HostInfo("gpu-box", count=10, cpus=32,
                                         mem=64000, gpus=8)]

    queue = [mk_job(P, mem=16000, cpus=8) for _ in range(5)]
    queue += [mk_job(P, mem=1000, cpus=1, gpus=4)]
    cycle = P.optimizer.OptimizerCycle(
        host_feed=Feed(), optimizer=P.optimizer.BacklogPurchaseOptimizer())
    out = cycle.run(queue, [], {"mem": 16000.0, "cpus": 8.0})
    assert out[0]["suggested-purchases"] == {"small": 5, "gpu-box": 1}

    class Small(P.optimizer.NoOpHostFeed):
        def get_available_host_info(self):
            return [P.optimizer.HostInfo("small", count=10, cpus=8,
                                         mem=16000)]

    cycle = P.optimizer.OptimizerCycle(
        host_feed=Small(), optimizer=P.optimizer.BacklogPurchaseOptimizer())
    assert cycle.run([mk_job(P, mem=100, cpus=1)], [],
                     {"mem": 99999.0, "cpus": 999.0})[0][
        "suggested-purchases"] == {}
