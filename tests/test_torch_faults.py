"""The fault plane and the overload reactions of `cook_tpu_torch` against
`cook_tpu` on the CPU:

- tests/test_faults.py's TestFaultSchedule, TestLoadShedder and
  TestAdmissionController on the port's `faults` and `faults/reactions`;
- the scheduler-rig cases that do not assume the reference's device-
  fallback ladder, each run on both packages with the reference's ladder
  off (`device_fallback_cycles=0`), which is the port's only behaviour: a
  `device.solve` error propagates out of the serial and batched passes
  and skips the pool with `solve-failed` on the pipelined one; nothing is
  re-solved on the CPU;
- the `cluster.offers`, `cluster.launch` and `cluster.kill` points
  (breaker integration, a skipped offer scan, a kill RPC that fails);
- the simulator's `fault_schedule` (nesting restored) and a simulator
  parity case with `fault_schedule` and `history_every`: the run trace
  and the metrics history (every series both packages carry, on the
  virtual clock) equal the JAX simulator's."""
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest
import torch

from cook_tpu import faults as ref_faults
from cook_tpu.cluster import mock as ref_mock
from cook_tpu.models import entities as ref_ent
from cook_tpu.models import store as ref_store
from cook_tpu.scheduler import core as ref_core
from cook_tpu.scheduler import flight_recorder as ref_flight
from cook_tpu.scheduler import matcher as ref_matcher
from cook_tpu.sim import simulator as ref_sim
from cook_tpu_torch import faults
from cook_tpu_torch.cluster import mock as port_mock
from cook_tpu_torch.faults.reactions import AdmissionController, LoadShedder
from cook_tpu_torch.models import entities as port_ent
from cook_tpu_torch.models import store as port_store
from cook_tpu_torch.scheduler import core as port_core
from cook_tpu_torch.scheduler import flight_recorder as port_flight
from cook_tpu_torch.scheduler import matcher as port_matcher
from cook_tpu_torch.scheduler.matcher import PoolMatchState
from cook_tpu_torch.sim import simulator as port_sim
from tests.conftest import FakeClock

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# one intra-op thread: the suite runs several pytest-xdist workers side
# by side, and idle OpenMP threads spinning in each would crowd them
torch.set_num_threads(1)

# the reference with its fallback ladder off is the port's behaviour
REF = SimpleNamespace(name="ref", faults=ref_faults, mock=ref_mock,
                      ent=ref_ent, store=ref_store, core=ref_core,
                      flight=ref_flight, sim=ref_sim,
                      match=lambda **kw: ref_matcher.MatchConfig(
                          device_fallback_cycles=0, **kw), kw={})
PORT = SimpleNamespace(name="port", faults=faults, mock=port_mock,
                       ent=port_ent, store=port_store, core=port_core,
                       flight=port_flight, sim=port_sim,
                       match=port_matcher.MatchConfig,
                       kw={"device": "cpu"})
PKGS = pytest.mark.parametrize("P", [REF, PORT], ids=["ref", "port"])


@pytest.fixture(autouse=True)
def _no_schedule_leaks():
    """Every test starts and ends disarmed, in both packages."""
    for f in (faults, ref_faults):
        f.disarm()
    yield
    for f in (faults, ref_faults):
        f.disarm()


# ------------------------------------------------------------- schedule


class TestFaultSchedule:
    def test_unknown_point_and_mode_rejected(self):
        with pytest.raises(ValueError):
            faults.FaultRule(point="journal.fsyncc")
        with pytest.raises(ValueError):
            faults.FaultRule(point=faults.JOURNAL_FSYNC, mode="explode")

    def test_unarmed_site_is_a_noop(self):
        assert faults.ACTIVE is None  # the only check a site pays

    def test_error_rule_rides_oserror_paths(self):
        with faults.injected({"point": "cluster.launch"}):
            with pytest.raises(OSError):
                faults.ACTIVE.hit(faults.CLUSTER_LAUNCH, cluster="c")

    def test_times_bounds_firings(self):
        with faults.injected({"point": "cluster.launch", "times": 2}) as s:
            for _ in range(2):
                with pytest.raises(faults.FaultInjected):
                    s.hit(faults.CLUSTER_LAUNCH)
            s.hit(faults.CLUSTER_LAUNCH)  # exhausted: no raise
            assert s.fired_total() == 2

    def test_after_skips_the_first_hits(self):
        with faults.injected({"point": "device.solve", "after": 2}) as s:
            s.hit(faults.DEVICE_SOLVE)
            s.hit(faults.DEVICE_SOLVE)
            with pytest.raises(faults.FaultInjected):
                s.hit(faults.DEVICE_SOLVE)

    def test_match_filters_on_context(self):
        rule = {"point": "cluster.launch", "match": {"cluster": "sick"}}
        with faults.injected(rule) as s:
            s.hit(faults.CLUSTER_LAUNCH, cluster="healthy")
            with pytest.raises(faults.FaultInjected):
                s.hit(faults.CLUSTER_LAUNCH, cluster="sick")
            # a context that lacks the matched key entirely does not fire
            s.hit(faults.CLUSTER_LAUNCH)
            assert s.fired_total() == 1

    def test_probability_is_seeded_and_deterministic(self):
        def firings(pkg, seed):
            schedule = pkg.FaultSchedule(
                [pkg.FaultRule(point=pkg.DEVICE_SOLVE, probability=0.5)],
                seed=seed)
            out = []
            for _ in range(20):
                try:
                    schedule.hit(pkg.DEVICE_SOLVE)
                    out.append(0)
                except pkg.FaultInjected:
                    out.append(1)
            return out

        assert firings(faults, 7) == firings(faults, 7)
        assert 0 < sum(firings(faults, 7)) < 20
        # the same seed draws the same firings in both packages
        assert firings(faults, 7) == firings(ref_faults, 7)

    def test_delay_mode_sleeps_without_raising(self):
        slept = []
        schedule = faults.FaultSchedule(
            [faults.FaultRule(point=faults.JOURNAL_FSYNC, mode="delay",
                              delay_s=0.25)], sleep=slept.append)
        schedule.hit(faults.JOURNAL_FSYNC)
        assert slept == [0.25]

    def test_injected_nesting_restores_previous_schedule(self):
        with faults.injected({"point": "device.solve"}) as outer:
            with faults.injected({"point": "journal.fsync"}):
                assert faults.ACTIVE is not outer
            assert faults.ACTIVE is outer
        assert faults.ACTIVE is None

    def test_schedule_roundtrips_through_dict(self):
        src = {"seed": 3, "rules": [
            {"point": "k8s.request", "mode": "delay", "delay_s": 0.1,
             "times": 4, "match": {"method": "GET"}}]}
        d = faults.FaultSchedule.from_dict(src).to_dict()
        assert d == ref_faults.FaultSchedule.from_dict(src).to_dict()
        assert d["seed"] == 3
        assert d["rules"][0]["point"] == "k8s.request"
        assert d["rules"][0]["match"] == {"method": "GET"}
        assert d["rules"][0]["fired"] == 0


# ----------------------------------------------------- reactions (unit)


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class _FakeContention:
    def __init__(self):
        self.reasons = []
        self.evaluations = 0

    def evaluate(self):
        self.evaluations += 1
        return [{"reason": r} for r in self.reasons], {}


class TestLoadShedder:
    def test_sheds_only_on_shed_relevant_reasons(self):
        contention = _FakeContention()
        clock = _Clock()
        shedder = LoadShedder(contention, ttl_s=0.0, clock=clock)
        assert shedder.should_shed("/queue") is None
        contention.reasons = ["fsync-stall"]  # detected but not shed-able
        clock.t += 1
        assert shedder.should_shed("/queue") is None
        contention.reasons = ["commit-ack-slo-burn"]
        clock.t += 1
        verdict = shedder.should_shed("/queue")
        assert verdict is not None
        assert verdict["reasons"] == ["commit-ack-slo-burn"]
        assert verdict["retry_after_s"] > 0
        assert shedder.overloaded()

    def test_ttl_caches_the_evaluation(self):
        contention = _FakeContention()
        clock = _Clock()
        shedder = LoadShedder(contention, ttl_s=5.0, clock=clock)
        for _ in range(10):
            shedder.should_shed("/jobs")
        assert contention.evaluations == 1
        clock.t += 6.0
        shedder.should_shed("/jobs")
        assert contention.evaluations == 2


class TestAdmissionController:
    def test_scaleback_floor_and_reset(self):
        overloaded = {"v": True}
        admission = AdmissionController(overload_fn=lambda: overloaded["v"],
                                        scaleback=0.5, floor_fraction=0.1)
        state = PoolMatchState(num_considerable=100)
        steps0 = admission._scalebacks.value({"pool": "p"})
        admission.clamp("p", state, 100)
        assert state.num_considerable == 50
        for _ in range(10):  # keep shrinking to the floor, never below
            admission.clamp("p", state, 100)
        assert admission.cap("p") == 10
        # only actual shrink steps count (100->50->25->12->10)
        assert admission._scalebacks.value({"pool": "p"}) - steps0 == 4
        overloaded["v"] = False  # burn clears: cap resets to max
        state.num_considerable = 5  # matcher's own backoff stays OWNED
        admission.clamp("p", state, 100)
        assert admission.cap("p") == 100
        assert state.num_considerable == 5

    def test_broken_overload_signal_fails_open(self):
        def boom():
            raise RuntimeError("signal down")

        admission = AdmissionController(overload_fn=boom)
        state = PoolMatchState(num_considerable=100)
        admission.clamp("p", state, 100)  # must not raise
        assert state.num_considerable == 100


def _admission_caps(P):
    """The admission cap of 50 overloaded serial cycles, then the cap after
    one batched pass with the overload cleared."""
    clock, store, cluster, scheduler, _ = _scheduler_rig(P, n_jobs=2)
    overloaded = {"v": True}
    scheduler.admission.overload_fn = lambda: overloaded["v"]
    pool = store.pools["default"]
    caps = []
    for _ in range(50):
        scheduler.rank_cycle(pool)
        scheduler.match_cycle(pool)
        caps.append(scheduler.admission.cap("default"))
    overloaded["v"] = False
    scheduler.match_cycle_all_pools()
    return caps, scheduler.admission.cap("default")


@PKGS
def test_scheduler_clamps_the_considerable_window_under_overload(P):
    """The scheduler's admission controller on the serial pass and the
    multi-pool prologue: x0.95 a cycle while overloaded, floored at a
    tenth of the window, reset when the signal clears."""
    caps, reset = _admission_caps(P)
    assert caps[:3] == [950, 902, 856]
    assert caps[-1] == 100  # the floor: a tenth of max_jobs_considered
    assert reset == 1000


def test_admission_caps_equal_the_reference():
    """The port's cap sequence is the reference's, cycle by cycle."""
    assert _admission_caps(PORT) == _admission_caps(REF)


# -------------------------------------------- scheduler-level fault points


def _scheduler_rig(P, n_hosts=4, n_jobs=6, **match_kw):
    """tests/test_faults.py:544 on either package (no fallback ladder)."""
    clock = FakeClock()
    store = P.store.JobStore(clock=clock)
    store.set_pool(P.ent.Pool(name="default"))
    hosts = [P.mock.MockHost(node_id=f"h{i}", hostname=f"h{i}", mem=4000,
                             cpus=8) for i in range(n_hosts)]
    cluster = P.mock.MockCluster("mock", hosts, clock=clock)
    scheduler = P.core.Scheduler(store, [cluster], P.core.SchedulerConfig(
        match=P.match(chunk=0, **match_kw)), **P.kw)
    jobs = [P.ent.Job(uuid=f"flt-{i:03d}", user=f"u{i % 3}",
                      pool="default", command="true",
                      resources=P.ent.Resources(mem=200, cpus=1),
                      max_retries=5)
            for i in range(n_jobs)]
    store.submit_jobs(jobs)
    return clock, store, cluster, scheduler, jobs


def _match_once(scheduler, store, clock):
    pool = store.pools["default"]
    scheduler.rank_cycle(pool)
    outcome = scheduler.match_cycle(pool)
    clock.advance(1000)
    return outcome


def _late_job(P, i):
    return P.ent.Job(uuid=f"late-{i}", user="late", pool="default",
                     command="true",
                     resources=P.ent.Resources(mem=200, cpus=1),
                     max_retries=5)


@PKGS
def test_kill_races_an_open_breaker(P):
    """test_faults.py:580: kills are never gated — a job killed while its
    cluster's breaker is open still reaches the backend, and recovery
    neither resurrects it nor double-launches anything."""
    clock, store, cluster, scheduler, jobs = _scheduler_rig(P)
    _match_once(scheduler, store, clock)
    running = P.ent.JobState.RUNNING
    assert all(store.jobs[j.uuid].state is running for j in jobs)
    breaker = cluster.configure_breaker(type(cluster.breaker.params)(
        window=4, min_samples=2, error_threshold=0.5, cooldown_s=0.2))
    late = [_late_job(P, i) for i in range(2)]
    store.submit_jobs(late)
    with P.faults.injected({"point": "cluster.launch", "times": 2,
                            "match": {"cluster": "mock"}}):
        _match_once(scheduler, store, clock)
        _match_once(scheduler, store, clock)
    assert breaker.state.value == "open"
    victim = jobs[0]
    task_ids = {i.task_id for i in store.live_instances_of_job(victim.uuid)}
    store.kill_jobs([victim.uuid])
    assert store.jobs[victim.uuid].state is P.ent.JobState.COMPLETED
    assert not any(t in cluster.running for t in task_ids), \
        "open breaker blocked the kill RPC"
    assert breaker.state.value == "open"  # kills don't close it
    time.sleep(0.25)  # cooldown -> the next launch is the probe
    for _ in range(4):
        _match_once(scheduler, store, clock)
        if all(store.jobs[j.uuid].state is running for j in late):
            break
    assert breaker.state.value == "closed"
    live = [i for i in store.instances.values() if not i.status.terminal]
    assert len({i.task_id for i in live}) == len(live)
    assert set(cluster.running) == {i.task_id for i in live}


@PKGS
def test_open_breaker_skips_with_circuit_reason(P):
    """test_faults.py:627: an open breaker withholds its cluster's offers
    and the jobs skip with `cluster-circuit-open`, not `no-offers`."""
    clock, store, cluster, scheduler, jobs = _scheduler_rig(P, n_jobs=3)
    cluster.configure_breaker(type(cluster.breaker.params)(
        window=4, min_samples=2, error_threshold=0.5, cooldown_s=60.0))
    with P.faults.injected({"point": "cluster.launch", "times": 2}):
        _match_once(scheduler, store, clock)
        _match_once(scheduler, store, clock)
    launched = len(store.instances)
    _match_once(scheduler, store, clock)  # open: no offers, no txns
    assert len(store.instances) == launched
    reason = scheduler.recorder.job_reason(jobs[0].uuid)
    assert reason is not None
    assert reason[1] == P.flight.CLUSTER_CIRCUIT_OPEN


@PKGS
def test_offer_scan_failure_skips_cluster_not_cycle(P):
    """test_faults.py:644: a raising offer scan (`cluster.offers`) skips
    the cluster for that scan (`safe_pool_offers` answers None) instead of
    taking the cycle down; the next cycle places everything."""
    clock, store, cluster, scheduler, jobs = _scheduler_rig(P, n_jobs=2)
    base = __import__(P.mock.__name__.replace(".mock", ".base"),
                      fromlist=["safe_pool_offers"])
    with P.faults.injected({"point": "cluster.offers", "times": 1}) as s:
        assert base.safe_pool_offers(cluster, "default") is None
        assert base.safe_pool_offers(cluster, "default")
        assert s.fired_total() == 1
    with P.faults.injected({"point": "cluster.offers", "times": 1}) as s:
        _match_once(scheduler, store, clock)  # a scan raised: skipped
        assert s.fired_total() == 1
    _match_once(scheduler, store, clock)
    assert all(store.jobs[j.uuid].state is P.ent.JobState.RUNNING
               for j in jobs)


@PKGS
def test_kill_rpc_failure_feeds_the_breaker_and_never_raises(P):
    """The `cluster.kill` point: a failing kill RPC is swallowed by
    `safe_kill_task` (kill must never propagate), counted as a breaker
    failure, and leaves the task running in the backend."""
    clock, store, cluster, scheduler, jobs = _scheduler_rig(P, n_jobs=2)
    _match_once(scheduler, store, clock)
    task_id = next(iter(cluster.running))
    with P.faults.injected({"point": "cluster.kill", "times": 1,
                            "match": {"task_id": task_id}}) as s:
        cluster.safe_kill_task(task_id)
        assert s.fired_total() == 1
    assert task_id in cluster.running
    assert cluster.breaker.snapshot()["recent_errors"] == 1
    cluster.safe_kill_task(task_id)  # disarmed: the kill lands
    assert task_id not in cluster.running


@PKGS
def test_device_solve_error_propagates_from_the_serial_pass(P):
    """test_faults.py:692 (the ladder off): the injected error raises out
    of `match_cycle` as OSError, nothing launches (nothing was re-solved
    on the CPU), and the next cycle places what a healthy cycle places."""
    clock, store, cluster, scheduler, jobs = _scheduler_rig(P, n_jobs=2)
    with P.faults.injected({"point": "device.solve", "times": 1}) as s:
        with pytest.raises(OSError):
            _match_once(scheduler, store, clock)
        assert s.fired_total() == 1
    assert not store.instances and not cluster.running
    assert all(store.jobs[j.uuid].state is P.ent.JobState.WAITING
               for j in jobs)
    outcome = _match_once(scheduler, store, clock)
    assert len(outcome.matched) == len(jobs)


def test_device_solve_delay_lands_in_the_solve_phase():
    """A `delay` rule at `device.solve` stalls the solve the record
    times: the cycle's solve phase holds the injected latency."""
    clock, store, cluster, scheduler, jobs = _scheduler_rig(PORT, n_jobs=2)
    with faults.injected({"point": "device.solve", "mode": "delay",
                          "delay_s": 0.2, "times": 1}):
        outcome = _match_once(scheduler, store, clock)
    assert len(outcome.matched) == 2
    record = scheduler.recorder.records(limit=1)[0]
    assert record.phases["solve"] >= 0.2
    assert outcome.phase_wall_s["solve"] >= 0.2


def _multi_pool_rig(P, n_pools=3, chunk=0):
    """tests/test_faults.py:700 on either package (no fallback ladder)."""
    clock = FakeClock()
    store = P.store.JobStore(clock=clock)
    hosts = []
    for p in range(n_pools):
        store.set_pool(P.ent.Pool(name=f"pool{p}"))
        hosts.append(P.mock.MockHost(node_id=f"p{p}h0", hostname=f"p{p}h0",
                                     mem=4000, cpus=8, pool=f"pool{p}"))
    cluster = P.mock.MockCluster("mock", hosts, clock=clock)
    scheduler = P.core.Scheduler(store, [cluster], P.core.SchedulerConfig(
        match=P.match(chunk=chunk)), **P.kw)
    jobs = [P.ent.Job(uuid=f"bat-{p}-{i}", user=f"u{i % 2}", pool=f"pool{p}",
                      command="true",
                      resources=P.ent.Resources(mem=200, cpus=1),
                      max_retries=5)
            for p in range(n_pools) for i in range(3)]
    store.submit_jobs(jobs)
    return clock, store, cluster, scheduler, jobs


@PKGS
def test_device_solve_error_propagates_from_the_batched_pass(P):
    """The batched pass's fault point fails the SHARED solve: the error
    raises out of `match_cycle_all_pools` and no pool launches."""
    clock, store, cluster, scheduler, jobs = _multi_pool_rig(P)
    with P.faults.injected({"point": "device.solve", "times": 1,
                            "match": {"pool": "pool1"}}) as s:
        with pytest.raises(OSError):
            scheduler.match_cycle_all_pools()
        assert s.fired_total() == 1
    assert not store.instances
    outcomes = scheduler.match_cycle_all_pools()
    assert sum(len(o.matched) for o in outcomes.values()) == len(jobs)


@PKGS
def test_device_solve_error_on_a_two_level_pool_in_the_batched_pass(P):
    """A pool at the hierarchical threshold solves alone in the batched
    pass; its fault point raises there too."""
    clock, store, cluster, scheduler, jobs = _multi_pool_rig(P, chunk=16)
    scheduler.config.match.hierarchical_threshold = 1
    with P.faults.injected({"point": "device.solve", "times": 1}):
        with pytest.raises(OSError):
            scheduler.match_cycle_all_pools()
    assert not store.instances


@PKGS
def test_device_solve_error_skips_the_pool_on_the_pipelined_pass(P):
    """The pipelined pass marks the failing pool's jobs `solve-failed`
    (counted on its record), launches nothing of it, and the other pools
    place as usual."""
    clock, store, cluster, scheduler, jobs = _multi_pool_rig(P)
    for pool in store.pools.values():
        scheduler.rank_cycle(pool)
    with P.faults.injected({"point": "device.solve", "times": 1,
                            "match": {"pool": "pool1"}}) as s:
        outcomes = scheduler.match_cycle_pipelined()
        assert s.fired_total() == 1
    scheduler.drain_launches()
    assert not outcomes["pool1"].matched
    assert len(outcomes["pool1"].unmatched) == 3
    assert len(outcomes["pool0"].matched) == len(outcomes["pool2"].matched) \
        == 3
    for i in range(3):
        reason = scheduler.recorder.job_reason(f"bat-1-{i}")
        assert reason[1] == P.flight.SOLVE_FAILED
    assert not any(i.job_uuid.startswith("bat-1-")
                   for i in store.instances.values())


def test_serial_and_pipelined_fault_outcomes_equal_the_reference():
    """The same armed schedule on both packages gives the same launches:
    the serial pass raises in both, the pipelined pass skips the same
    pool and launches the same (job, host) pairs."""
    got = {}
    for P in (REF, PORT):
        clock, store, cluster, scheduler, jobs = _multi_pool_rig(P)
        for pool in store.pools.values():
            scheduler.rank_cycle(pool)
        with P.faults.injected({"point": "device.solve", "times": 1,
                                "match": {"pool": "pool2"}}):
            outcomes = scheduler.match_cycle_pipelined()
        scheduler.drain_launches()
        got[P.name] = {name: sorted((j.uuid, o.hostname)
                                    for j, o in out.matched)
                       for name, out in outcomes.items()}
    assert got["port"] == got["ref"]
    assert got["port"]["pool2"] == []


# ------------------------------------------------------------ simulator


class TestSimulatorFaultNesting:
    def test_sim_run_restores_the_outer_schedule(self):
        """test_faults.py:771: Simulator.run arms SimConfig.fault_schedule
        and RESTORES a schedule armed around it."""
        jobs = [port_sim.TraceJob(uuid="j0", user="u", submit_time_ms=0,
                                  runtime_ms=1000, mem=100, cpus=1)]
        hosts = [port_sim.TraceHost(node_id="n0", hostname="n0", mem=2000,
                                    cpus=4)]
        sim = port_sim.Simulator(jobs, hosts, port_sim.SimConfig(
            cycle_ms=1000, max_cycles=4,
            fault_schedule={"rules": [{"point": "cluster.offers",
                                       "mode": "error", "times": 1}]}),
            device="cpu")
        with faults.injected({"point": "cluster.kill", "mode": "error"}):
            outer = faults.ACTIVE
            result = sim.run()
            assert faults.ACTIVE is outer  # restored, not disarmed
        assert faults.ACTIVE is None
        assert result.rows[0]["status"] == "success"


def test_elastic_reconcile_survives_a_flapping_offers_rpc():
    """test_faults.py:797: `CapacityPlanner.reconcile` scans offers
    through `safe_pool_offers`, so an armed `cluster.offers` error skips
    the cluster instead of raising out of the commit path."""
    from cook_tpu_torch.elastic import CapacityPlanner, ElasticParams
    from cook_tpu_torch.txn import TransactionLog

    clock = FakeClock()
    store = port_store.JobStore(clock=clock)
    store.set_pool(port_ent.Pool(name="default"))
    cluster = port_mock.MockCluster("m", [port_mock.MockHost(
        node_id="h0", hostname="h0", mem=4000, cpus=8)], clock=clock)
    planner = CapacityPlanner(store, [cluster], TransactionLog(store),
                              ElasticParams(enabled=True), device="cpu")
    with faults.injected({"point": "cluster.offers", "mode": "error"}) as s:
        planner.reconcile()  # must not raise
        assert s.fired_total() >= 1


# the history series whose values are host-clock walls (never equal across
# two runs) and the history's own bookkeeping
WALL_CLOCK = ("seconds", "duration", "span.", "history.")
# the series only the reference carries: none since the port has the
# job-lifecycle tracker and the profiled store lock (the service slice)
REF_ONLY = ()
FAULT_SCHEDULE = {"seed": 1, "rules": [
    {"point": "cluster.launch", "mode": "error", "times": 2},
    {"point": "cluster.offers", "mode": "error", "times": 1}]}


def _fault_history_runs() -> dict:
    """Both simulators on one trace with FAULT_SCHEDULE armed and a
    history tick every 2 cycles: {package: {"csv", "history", "armed"}}.
    Run in a fresh interpreter: the metrics registries are process-wide,
    and series other tests left behind would show in the dumps."""
    out = {}
    for P in (REF, PORT):
        jobs, hosts = P.sim.synth_trace(n_jobs=120, n_hosts=12, seed=3)
        result = P.sim.Simulator(jobs, hosts, P.sim.SimConfig(
            max_cycles=12, fault_schedule=FAULT_SCHEDULE, history_every=2,
            scheduler=P.core.SchedulerConfig(match=P.match())),
            **P.kw).run()
        out[P.name] = {"csv": result.to_csv(),
                       "history": result.metrics_history,
                       "armed": P.faults.ACTIVE is not None}
    return out


def test_sim_fault_schedule_and_history_equal_the_reference():
    """A simulator run with a fault schedule (two launch failures, one
    failed offer scan) and a metrics-history tick every 2 cycles, in a
    fresh interpreter: the run trace equals the JAX simulator's, and so
    does the history — every series of the port's dump is in the
    reference's with the same virtual-clock timestamps, and the same
    values wherever they are not host-clock walls."""
    code = ("import json, tests.test_torch_faults as t\n"
            "print(json.dumps(t._fault_history_runs()))\n")
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    runs = json.loads(proc.stdout.strip().splitlines()[-1])
    got, want = runs["port"], runs["ref"]
    assert not got["armed"] and not want["armed"]  # disarmed after run()
    assert got["csv"] == want["csv"]
    assert "failed" in got["csv"], "the launch faults failed no instance"
    for step in ("raw", "10m"):
        g = got["history"][step]["series"]
        w = want["history"][step]["series"]
        assert set(g) == {k for k in w if not k.startswith(REF_ONLY)}
        assert g["faults.injected.rate{mode=error,point=cluster.launch}"]
        assert g["breaker.state{cluster=sim}"]
        for key in g:
            # raw points are [t, value]; rollup buckets {"t": .., ...}
            stamps = [[p["t"] if isinstance(p, dict) else p[0] for p in
                       series] for series in (g[key], w[key])]
            assert stamps[0] == stamps[1], (step, key)
            if not any(m in key for m in WALL_CLOCK):
                assert g[key] == w[key], (step, key)
