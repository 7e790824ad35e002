"""A failed device solve marks the pool `device-degraded` on both packages.

The reference re-solves the failing cycle on the CPU and reports
`device-degraded` with one incident bundle until its device probe passes
(`tools/chaos.py`'s `device-fallback` scenario).  The port re-solves
nothing: the serial and batched passes raise and the pipelined pass skips
the pool's jobs, and each notes the pool on the telemetry first
(`scheduler/matcher.note_solve_failed`), so health reads `device-degraded`
naming the pool and the incident recorder captures one bundle; the pool's
next solve on the card (the CPU here) clears it."""
import pathlib
import sys

import pytest
import torch

from cook_tpu_torch import faults
from cook_tpu_torch.cluster.mock import MockCluster, MockHost
from cook_tpu_torch.models.entities import Job, JobState, Pool, Resources
from cook_tpu_torch.models.store import JobStore
from cook_tpu_torch.scheduler import flight_recorder as flight_codes
from cook_tpu_torch.scheduler.core import Scheduler, SchedulerConfig
from cook_tpu_torch.scheduler.matcher import SOLVE_ERROR, MatchConfig

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent / "tools"))

import chaos as ref_chaos  # noqa: E402

torch.set_num_threads(1)


class Clock:
    def __init__(self):
        self.ms = 0

    def __call__(self):
        return self.ms


def rig(match):
    """The chaos drill's rig (3 hosts of 4,000 MB / 8 cpus, 6 jobs of
    200 MB / 1 cpu) on the CPU."""
    clock = Clock()
    store = JobStore(clock=clock)
    store.set_pool(Pool(name="default"))
    cluster = MockCluster("chaos", [
        MockHost(node_id=f"h{i}", hostname=f"h{i}", mem=4000, cpus=8)
        for i in range(3)], clock=clock)
    scheduler = Scheduler(store, [cluster], SchedulerConfig(match=match),
                          device="cpu")
    store.submit_jobs([Job(uuid=f"dev-{i:03d}", user=f"u{i % 3}",
                           pool="default", command="true",
                           resources=Resources(mem=200, cpus=1),
                           max_retries=5) for i in range(6)])
    return clock, store, cluster, scheduler


FLAT = MatchConfig(chunk=0)
HIER = MatchConfig(chunk=0, hierarchical_threshold=1,
                   hierarchical_use_mesh=False)


def serial(scheduler, store):
    pool = store.pools["default"]
    scheduler.rank_cycle(pool)
    return scheduler.match_cycle(pool).matched


def batched(scheduler, store):
    scheduler.rank_cycle(store.pools["default"])
    return scheduler.match_cycle_all_pools()["default"].matched


def pipelined(scheduler, store):
    scheduler.rank_cycle(store.pools["default"])
    return scheduler.match_cycle_pipelined()["default"].matched


PASSES = {
    "serial": (serial, FLAT, True),
    "serial-hierarchical": (serial, HIER, True),
    "batched": (batched, FLAT, True),
    "batched-hierarchical": (batched, HIER, True),
    # the pipelined pass skips the failed pool's jobs instead of raising
    "pipelined": (pipelined, FLAT, False),
}


@pytest.fixture(autouse=True)
def _disarm():
    yield
    faults.disarm()


def test_reference_device_fallback_marks_the_pool_degraded_then_clears():
    """The reference's own drill: device-degraded plus one bundle after
    the failing cycle (re-solved on the CPU), cleared after the probe."""
    result = ref_chaos.run_scenario("device-fallback")
    assert result.passed, result.error
    assert any("device-degraded" in step for step in result.steps)
    assert any("probe succeeded, health ok" in step
               for step in result.steps)


@pytest.mark.parametrize("name", sorted(PASSES))
def test_port_failed_solve_marks_the_pool_degraded_then_clears(name):
    run, match, raises = PASSES[name]
    _, store_a, _, sched_a = rig(match)
    healthy = {(j.uuid, o.hostname) for j, o in run(sched_a, store_a)}
    assert len(healthy) == 6

    clock, store, cluster, scheduler = rig(match)
    faults.arm(faults.FaultSchedule([faults.FaultRule(
        point=faults.DEVICE_SOLVE, mode="error", times=1)]))
    if raises:
        with pytest.raises(faults.FaultInjected):
            run(scheduler, store)
    else:
        assert run(scheduler, store) == []
        code = scheduler.recorder.job_reason("dev-000")[1]
        assert code == flight_codes.SOLVE_FAILED
    clock.ms += 1000
    # nothing re-solved on the CPU: no instance, no launch
    assert not store.instances and not cluster.running

    verdict = scheduler.telemetry.health()
    assert verdict["reasons"] == ["device-degraded"]
    (entry,) = verdict["degradations"]
    assert entry["pool"] == "default" and entry["cause"] == SOLVE_ERROR
    assert entry["cycles"] == 1
    bundles = scheduler.incidents.bundles()
    assert len(bundles) == 1
    bundle = scheduler.incidents.get(bundles[0]["id"])
    assert "device-degraded" in bundle["reasons"]
    assert any(r.get("point") == "device.solve"
               for r in (bundle.get("faults") or {}).get("rules", []))

    # the rule is spent: the next pass solves and clears the verdict
    recovered = {(j.uuid, o.hostname) for j, o in run(scheduler, store)}
    assert recovered == healthy
    verdict = scheduler.telemetry.health()
    assert verdict["status"] == "ok" and verdict["reasons"] == []
    assert scheduler.telemetry.device_fallbacks() == {}
    assert all(j.state is JobState.RUNNING for j in store.jobs.values())
    # the recovery stamps the open bundle; no second one is captured
    assert len(scheduler.incidents.bundles()) == 1


def test_port_verdict_counts_consecutive_failed_cycles():
    """Two failed cycles in a row: one episode (one bundle) whose evidence
    counts both, as the reference's counts its fallback cycles."""
    clock, store, _, scheduler = rig(FLAT)
    faults.arm(faults.FaultSchedule([faults.FaultRule(
        point=faults.DEVICE_SOLVE, mode="error", times=2)]))
    for _ in range(2):
        with pytest.raises(faults.FaultInjected):
            serial(scheduler, store)
        clock.ms += 1000
        verdict = scheduler.telemetry.health()
    (entry,) = verdict["degradations"]
    assert entry["cycles"] == 2 and entry["cycles_left"] == 0
    assert len(scheduler.incidents.bundles()) == 1
    assert len(serial(scheduler, store)) == 6
    assert scheduler.telemetry.health()["reasons"] == []
