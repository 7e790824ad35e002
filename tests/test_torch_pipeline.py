"""The pipelined multi-pool pass of `cook_tpu_torch` against `cook_tpu`
on the CPU: the ports of tests/test_pipeline.py's engine and launch
fan-out cases, each run on both packages (`pkg` ref / port).

- :57 every pool matches and the launches are drained when the pass
  returns; :70 pipelined placements equal the serial ones, and the port's
  equal the reference's; :81 store transactions commit in pool order;
  :93 the overlap fields of the cycle records;
- :110 a fetch that raises (monkeypatched) skips that pool's jobs with
  `solve-failed` while its neighbours match; the port has no CPU re-solve
  tier, so this is its only failure path (the reference's, with its
  fallback off);
- :235 an async launch failure flows back to the store and the record;
  :299 a kill waits for a launch in progress; :324 a kill racing a queued
  launch batch is not undone; :350 the executor's completion tracking.

A hierarchical pool in the pipelined pass (solved at its fetch) and the
depth bound are covered beside them."""
import time
from types import SimpleNamespace

import pytest
import torch

from cook_tpu.cluster import base as ref_base
from cook_tpu.cluster import mock as ref_mock
from cook_tpu.models import entities as ref_ent
from cook_tpu.models import reasons as ref_reasons
from cook_tpu.models import store as ref_store
from cook_tpu.scheduler import core as ref_core
from cook_tpu.scheduler import flight_recorder as ref_flight
from cook_tpu.scheduler import matcher as ref_matcher
from cook_tpu.scheduler import pipeline as ref_pipeline
from cook_tpu_torch.cluster import base as port_base
from cook_tpu_torch.cluster import mock as port_mock
from cook_tpu_torch.models import entities as port_ent
from cook_tpu_torch.models import reasons as port_reasons
from cook_tpu_torch.models import store as port_store
from cook_tpu_torch.scheduler import core as port_core
from cook_tpu_torch.scheduler import flight_recorder as port_flight
from cook_tpu_torch.scheduler import matcher as port_matcher
from cook_tpu_torch.scheduler import pipeline as port_pipeline
from tests.conftest import FakeClock

# one intra-op thread: the suite runs several pytest-xdist workers side
# by side, and idle OpenMP threads spinning in each would crowd them
torch.set_num_threads(1)


def _pkg(**mods):
    return SimpleNamespace(**mods)


REF = _pkg(name="ref", ent=ref_ent, store=ref_store, mock=ref_mock,
           base=ref_base, core=ref_core, matcher=ref_matcher,
           pipeline=ref_pipeline, flight=ref_flight, reasons=ref_reasons,
           extra={})
PORT = _pkg(name="port", ent=port_ent, store=port_store, mock=port_mock,
            base=port_base, core=port_core, matcher=port_matcher,
            pipeline=port_pipeline, flight=port_flight,
            reasons=port_reasons, extra={"device": "cpu"})
PKGS = pytest.mark.parametrize("P", [REF, PORT], ids=["ref", "port"])


def _job(P, uuid, user, pool, mem, cpus=1.0):
    e = P.ent
    return e.Job(uuid=uuid, user=user, pool=pool, priority=50,
                 max_retries=1, command="true",
                 resources=e.Resources(mem=mem, cpus=cpus))


def setup_multi(P, n_pools=4, hosts_per_pool=3, jobs_per_pool=5, chunk=0,
                cluster_cls=None, **config_kw):
    """tests/test_pipeline.py:32's rig: pools pool0..pool{n-1} with their
    own 4000 MB / 8 cpu hosts (memory distinct by 100 MB a host when the
    chunked matcher runs, so that no two hosts tie: ROADMAP Queue C port
    item 3), jobs of 100-400 MB."""
    clock = FakeClock()
    store = P.store.JobStore(clock=clock)
    hosts = []
    for p in range(n_pools):
        store.set_pool(P.ent.Pool(name=f"pool{p}"))
        for i in range(hosts_per_pool):
            hosts.append(P.mock.MockHost(
                node_id=f"p{p}h{i}", hostname=f"p{p}h{i}",
                mem=4000 + (100 * i if chunk else 0), cpus=8,
                pool=f"pool{p}"))
    cluster = (cluster_cls or P.mock.MockCluster)("mock", hosts, clock=clock)
    config = P.core.SchedulerConfig(
        match=P.matcher.MatchConfig(chunk=chunk), **config_kw)
    scheduler = P.core.Scheduler(store, [cluster], config, **P.extra)
    jobs = [_job(P, f"job-{p}-{i}", f"u{i % 3}", f"pool{p}",
                 100.0 * (i % 4 + 1))
            for p in range(n_pools) for i in range(jobs_per_pool)]
    store.submit_jobs(jobs)
    return clock, store, cluster, scheduler, jobs


def _placements(outcomes):
    return {name: sorted((j.uuid, o.hostname) for j, o in out.matched)
            for name, out in outcomes.items()}


# ------------------------------------------------------------- the engine


def _all_pools(P, chunk):
    _, store, _, scheduler, jobs = setup_multi(P, chunk=chunk)
    outcomes = scheduler.match_cycle_pipelined()
    assert set(outcomes) == {f"pool{p}" for p in range(4)}
    assert sum(len(o.matched) for o in outcomes.values()) == len(jobs)
    for job in jobs:
        # drain_launches is on by default: backend effects are visible
        # when the pass returns, like the serial path
        assert store.jobs[job.uuid].state == P.ent.JobState.RUNNING
        [inst] = store.job_instances(job.uuid)
        assert inst.hostname.startswith(f"p{job.pool[-1]}")
    return _placements(outcomes)


@pytest.mark.parametrize("chunk", [0, 4], ids=["exact", "chunked"])
def test_pipelined_matches_all_pools_like_the_reference(chunk):
    assert _all_pools(PORT, chunk) == _all_pools(REF, chunk)


def _pipelined_vs_serial(P, **kw):
    _, _, _, sched1, _ = setup_multi(P, **kw)
    _, s2, _, sched2, _ = setup_multi(P, **kw)
    pipelined = _placements(sched1.match_cycle_pipelined())
    serial = _placements({p.name: sched2.match_cycle(p)
                          for p in s2.pools.values()})
    assert pipelined == serial
    return pipelined


@pytest.mark.parametrize("kw", [
    dict(chunk=0), dict(chunk=4), dict(chunk=4, pipeline_depth=1),
    dict(chunk=4, pipeline_depth=3, async_launch=False)],
    ids=["exact", "chunked", "depth1", "depth3-sync"])
def test_pipelined_equals_serial_decisions_like_the_reference(kw):
    assert _pipelined_vs_serial(PORT, **kw) == _pipelined_vs_serial(REF, **kw)


@PKGS
def test_transactions_commit_in_pool_order(P):
    _, store, _, scheduler, _ = setup_multi(P, n_pools=4)
    created_pools = []
    store.add_watcher(
        lambda e: created_pools.append(store.jobs[e.data["job"]].pool)
        if e.kind == "instance/created" else None)
    scheduler.match_cycle_pipelined()
    assert created_pools, "no launch transactions observed"
    # pool k's create transactions all land before pool k+1's first one
    assert created_pools == sorted(created_pools)


@PKGS
def test_overlap_accounting_fields(P):
    _, store, _, scheduler, _ = setup_multi(P)
    scheduler.match_cycle_pipelined()
    records = scheduler.recorder.records_json(limit=4)
    assert len(records) == 4
    for r in records:
        assert r["pipelined"] is True
        assert r["pipeline_wall_s"] > 0
        assert 0.0 <= r["overlap_fraction"] < 1.0
        assert "dispatch" in r["phases"] and "solve" in r["phases"]
        # every record of the pass shares the pass-level accounting
        assert r["pipeline_wall_s"] == records[0]["pipeline_wall_s"]
    # summed per-pool phase time can only exceed the wall by the overlap
    summed = sum(r["device_s"] + r["host_s"] for r in records)
    assert records[0]["overlap_s"] <= summed


def test_overlapped_solves_stay_out_of_the_latency_baseline():
    """`record_solve_outcome(..., overlapped=True)`: the pipelined solve
    wall reaches no latency surface (no baseline sample, no seconds in
    the last-solve snapshot), as in the reference."""
    snapshots = {}
    for P in (REF, PORT):
        _, _, _, scheduler, _ = setup_multi(P)
        scheduler.match_cycle_pipelined()
        tel = scheduler.telemetry
        snapshots[P.name] = ({pool: tel.solve_info(pool)
                              for pool in ("pool0", "pool3")},
                             tel.latency_stats())
    assert snapshots["port"] == snapshots["ref"]
    infos, latency = snapshots["port"]
    assert all("seconds" not in info for info in infos.values())
    assert latency == {}


@PKGS
def test_solve_failure_does_not_wedge_neighbor_pools(P, monkeypatch):
    _, store, _, scheduler, jobs = setup_multi(P, n_pools=3)
    if P is REF:
        # the fallback-disabled semantics: the port has no fallback tier
        scheduler.config.match.device_fallback_cycles = 0
    real_dispatch = P.pipeline.dispatch_pool_solve

    class Boom:
        def fetch(self):
            raise RuntimeError("injected device error")

    def dispatch(prepared, config, **kw):
        if prepared.pool.name == "pool1":
            return Boom()
        return real_dispatch(prepared, config, **kw)

    monkeypatch.setattr(P.pipeline, "dispatch_pool_solve", dispatch)
    outcomes = scheduler.match_cycle_pipelined()
    # pools 0 and 2 matched normally
    for p in (0, 2):
        assert len(outcomes[f"pool{p}"].matched) == 5
    # pool1's jobs wait a cycle with the solve-failed reason
    assert outcomes["pool1"].matched == []
    assert len(outcomes["pool1"].unmatched) == 5
    for job in jobs:
        if job.pool == "pool1":
            assert store.jobs[job.uuid].state == P.ent.JobState.WAITING
            _, code, _ = scheduler.recorder.job_reason(job.uuid)
            assert code == P.flight.SOLVE_FAILED


def test_a_dispatch_that_raises_fails_only_its_pool(monkeypatch):
    """A raise at dispatch time (not at fetch) takes the same
    solve-failed path, in the port as in the reference."""
    reasons = {}
    for P in (REF, PORT):
        _, store, _, scheduler, jobs = setup_multi(P, n_pools=3)
        if P is REF:
            scheduler.config.match.device_fallback_cycles = 0
        real = P.pipeline.dispatch_pool_solve

        def dispatch(prepared, config, _real=real, **kw):
            if prepared.pool.name == "pool2":
                raise RuntimeError("launch refused")
            return _real(prepared, config, **kw)

        monkeypatch.setattr(P.pipeline, "dispatch_pool_solve", dispatch)
        outcomes = scheduler.match_cycle_pipelined()
        reasons[P.name] = (
            _placements(outcomes),
            sorted(scheduler.recorder.job_reason(j.uuid)[1] for j in jobs))
    assert reasons["port"] == reasons["ref"]
    assert reasons["port"][1].count(port_flight.SOLVE_FAILED) == 5


def _hier_pipelined(P):
    """pool0 over the hierarchical threshold (100 hosts, padded to 128,
    x 64 padded jobs), pools 1-2 flat (64 x 64): pipelined and serial
    placements agree."""
    kw = dict(chunk=4, hierarchical_threshold=64 * 128,
              hierarchical_nodes_per_block=8)
    if P is REF:
        kw["hierarchical_use_mesh"] = False
    out = []
    for pipelined in (True, False):
        clock = FakeClock()
        store = P.store.JobStore(clock=clock)
        hosts = []
        for p, n in enumerate((100, 3, 3)):
            store.set_pool(P.ent.Pool(name=f"pool{p}"))
            hosts += [P.mock.MockHost(node_id=f"p{p}h{i:03d}",
                                      hostname=f"p{p}h{i:03d}",
                                      mem=4000 + 100 * i, cpus=8,
                                      pool=f"pool{p}") for i in range(n)]
        cluster = P.mock.MockCluster("mock", hosts, clock=clock)
        scheduler = P.core.Scheduler(
            store, [cluster],
            P.core.SchedulerConfig(match=P.matcher.MatchConfig(**kw)),
            **P.extra)
        store.submit_jobs([
            _job(P, f"job-{p}-{i:02d}", f"u{i % 3}", f"pool{p}",
                 100.0 * (i % 4 + 1)) for p in range(3) for i in range(20)])
        if pipelined:
            outcomes = scheduler.match_cycle_pipelined()
            backends = {r["pool"]: r["backend"]
                        for r in scheduler.recorder.records_json(limit=3)}
        else:
            outcomes = {p.name: scheduler.match_cycle(p)
                        for p in store.pools.values()}
        out.append(_placements(outcomes))
    assert out[0] == out[1]
    return out[0], backends


def test_pipelined_pass_with_a_hierarchical_pool_like_the_reference():
    got, backends = _hier_pipelined(PORT)
    assert (got, backends) == _hier_pipelined(REF)
    assert backends["pool0"].startswith("hier-")
    assert backends["pool1"] == "xla"


def test_depth_bounds_the_solves_in_flight(monkeypatch):
    """At most `pipeline_depth` dispatched solves are waiting for their
    fetch at any time, and fetches run in pool order."""
    real = port_pipeline.dispatch_pool_solve
    for depth in (1, 2, 3):
        _, _, _, scheduler, _ = setup_multi(PORT, n_pools=5,
                                            pipeline_depth=depth)
        events = []

        class Counted:
            def __init__(self, pending, name):
                self.pending, self.name = pending, name

            def fetch(self):
                events.append(("fetch", self.name))
                return self.pending.fetch()

        def dispatch(prepared, config, **kw):
            events.append(("dispatch", prepared.pool.name))
            return Counted(real(prepared, config, **kw), prepared.pool.name)

        monkeypatch.setattr(port_pipeline, "dispatch_pool_solve", dispatch)
        scheduler.match_cycle_pipelined()
        in_flight = peak = 0
        for kind, _ in events:
            in_flight += 1 if kind == "dispatch" else -1
            peak = max(peak, in_flight)
        assert peak == depth
        assert [n for k, n in events if k == "fetch"] == \
            [f"pool{p}" for p in range(5)]


# --------------------------------------------------------- launch fan-out


class RefFailingCluster(ref_mock.MockCluster):
    """launch_tasks raises mid fan-out (backend RPC failure)."""

    def launch_tasks(self, pool, specs):
        raise ConnectionError("backend unreachable")


class PortFailingCluster(port_mock.MockCluster):
    def launch_tasks(self, pool, specs):
        raise ConnectionError("backend unreachable")


@PKGS
def test_async_launch_failure_flows_to_store(P):
    failing = RefFailingCluster if P is REF else PortFailingCluster
    _, store, _, scheduler, jobs = setup_multi(P, n_pools=2,
                                               cluster_cls=failing)
    scheduler.match_cycle_pipelined()
    assert scheduler.drain_launches(timeout=10)
    expected_code = P.reasons.REASONS_BY_NAME["launch-failed"].code
    for job in jobs:
        live = store.jobs[job.uuid]
        # launch-failed is mea-culpa: the instance failed, the job
        # re-queues without consuming its retry budget
        assert live.state == P.ent.JobState.WAITING
        [inst] = store.job_instances(job.uuid)
        assert inst.status == P.ent.InstanceStatus.FAILED
        assert inst.reason_code == expected_code
        _, code, _ = scheduler.recorder.job_reason(job.uuid)
        assert code == P.flight.LAUNCH_FAILED
    # the failure landed in the committed cycle records too
    skipped = [s for r in scheduler.recorder.records_json(limit=2)
               for s in r["skipped"] if s["code"] == P.flight.LAUNCH_FAILED]
    assert len(skipped) == len(jobs)


def _slow_cluster(mock):
    class SlowCluster(mock.MockCluster):
        """Instrumented backend: records whether a kill ever interleaved
        a mid-flight launch (the kill-lock must make that impossible)."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.in_launch = False
            self.kill_during_launch = False

        def launch_tasks(self, pool, specs):
            self.in_launch = True
            time.sleep(0.3)
            super().launch_tasks(pool, specs)
            self.in_launch = False

        def kill_task(self, task_id):
            self.kill_during_launch |= self.in_launch
            super().kill_task(task_id)

    return SlowCluster("slow", [mock.MockHost(
        node_id="h0", hostname="h0", mem=4000, cpus=8)], clock=FakeClock())


def _spec(P, n):
    return P.base.TaskSpec(task_id=f"t-{n}", job_uuid=f"j-{n}", user="u",
                           command="true", mem=100, cpus=1, gpus=0,
                           node_id="h0", hostname="h0")


def _wait_in_launch(cluster):
    deadline = time.time() + 5
    while not cluster.in_launch and time.time() < deadline:
        time.sleep(0.005)
    assert cluster.in_launch


@PKGS
def test_async_launch_completion_races_kill(P):
    cluster = _slow_cluster(P.mock)
    cluster.launch_tasks_async("default", [_spec(P, 1)])
    # let the worker enter launch_tasks, then race a kill against it
    _wait_in_launch(cluster)
    t0 = time.perf_counter()
    cluster.safe_kill_task("t-1")
    waited = time.perf_counter() - t0
    assert cluster.wait_launches(timeout=5)
    assert not cluster.kill_during_launch
    # the kill blocked on the kill-lock until the launch finished
    assert waited > 0.05
    assert "t-1" not in cluster.running


@PKGS
def test_kill_racing_queued_launch_batch_is_not_resurrected(P):
    """The kill-lock only excludes kills during the backend call itself;
    a kill landing while the batch still sits in the async launch queue
    must not be undone when the batch finally runs."""
    cluster = _slow_cluster(P.mock)
    cluster.launch_tasks_async("default", [_spec(P, 1)])  # occupies worker
    cluster.launch_tasks_async("default", [_spec(P, 2)])  # sits in queue
    _wait_in_launch(cluster)
    cluster.safe_kill_task("t-2")                        # races the batch
    assert cluster.wait_launches(timeout=5)
    assert "t-1" in cluster.running
    assert "t-2" not in cluster.running                  # not resurrected


@PKGS
def test_launch_executor_completion_tracking(P):
    cluster = _slow_cluster(P.mock)
    cluster.launch_tasks_async("default", [_spec(P, 2)])
    assert cluster.pending_launches() >= 1
    assert cluster.wait_launches(timeout=5)
    assert cluster.pending_launches() == 0
    assert "t-2" in cluster.running
    # the one drain idiom: nothing stuck
    assert P.base.wait_all_launches([cluster], timeout=1) == []


def test_launch_queue_bound_applies_backpressure():
    """With `launch_queue_bound` 1, a second batch waits in
    `launch_tasks_async` until the first has run."""
    cluster = _slow_cluster(port_mock)
    cluster.launch_queue_bound = 1
    cluster.launch_tasks_async("default", [_spec(PORT, 1)])
    _wait_in_launch(cluster)
    t0 = time.perf_counter()
    cluster.launch_tasks_async("default", [_spec(PORT, 2)])
    assert time.perf_counter() - t0 > 0.1
    assert cluster.wait_launches(timeout=5)
    assert {"t-1", "t-2"} <= set(cluster.running)
