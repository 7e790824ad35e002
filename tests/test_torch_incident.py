"""The diagnosis layer of `cook_tpu_torch` against `cook_tpu` on the CPU:
the non-REST cases of tests/test_incident.py on the port — the profile
capturer (single flight, self-stop, duration clamp, auto-capture reason
filter and cooldown) with an injected profiler, the incident recorder
(the ok->degraded edge, cooldown and deferral, persistence and id
resume, concurrent observers), the end-to-end drill on the scheduler (a
`device.solve` latency fault -> one bundle with its evidence and an auto
profile -> recovery), the preempted job's timeline and the recorder's
per-job history — most of them on both packages with the same
assertions and their outputs compared.  The real `torch.profiler`
capture is held here on the CPU (a trace file, no nesting); its CUDA
kernel events are `chip_smoke.py`'s to show on the card."""
import json
import math
import os
import threading
import time
from types import SimpleNamespace

import pytest
import torch

from cook_tpu import faults as ref_faults
from cook_tpu.cluster import mock as ref_mock
from cook_tpu.models import entities as ref_ent
from cook_tpu.models import store as ref_store
from cook_tpu.obs import incident as ref_incident
from cook_tpu.obs import profiling as ref_profiling
from cook_tpu.obs import telemetry as ref_tel
from cook_tpu.scheduler import core as ref_core
from cook_tpu.scheduler import flight_recorder as ref_flight
from cook_tpu.scheduler import matcher as ref_matcher
from cook_tpu_torch import faults as port_faults
from cook_tpu_torch.cluster import mock as port_mock
from cook_tpu_torch.models import entities as port_ent
from cook_tpu_torch.models import store as port_store
from cook_tpu_torch.obs import incident as port_incident
from cook_tpu_torch.obs import profiling as port_profiling
from cook_tpu_torch.obs import telemetry as port_tel
from cook_tpu_torch.scheduler import core as port_core
from cook_tpu_torch.scheduler import flight_recorder as port_flight
from cook_tpu_torch.scheduler import matcher as port_matcher
from tests.conftest import FakeClock

# one intra-op thread: the suite runs several pytest-xdist workers side
# by side, and idle OpenMP threads spinning in each would crowd them
torch.set_num_threads(1)

REF = SimpleNamespace(name="ref", faults=ref_faults, mock=ref_mock,
                      ent=ref_ent, store=ref_store, incident=ref_incident,
                      profiling=ref_profiling, tel=ref_tel, core=ref_core,
                      flight=ref_flight,
                      match=lambda **kw: ref_matcher.MatchConfig(
                          device_fallback_cycles=0, **kw), kw={})
PORT = SimpleNamespace(name="port", faults=port_faults, mock=port_mock,
                       ent=port_ent, store=port_store,
                       incident=port_incident, profiling=port_profiling,
                       tel=port_tel, core=port_core, flight=port_flight,
                       match=port_matcher.MatchConfig,
                       kw={"device": "cpu"})
PKGS = pytest.mark.parametrize("P", [REF, PORT], ids=["ref", "port"])
ProfileCapturer = port_profiling.ProfileCapturer
IncidentRecorder = port_incident.IncidentRecorder


# ------------------------------------------------------- profile capturer


class FakeProfiler:
    def __init__(self, fail_start=False):
        self.started = []
        self.stopped = 0
        self.fail_start = fail_start

    def start(self, log_dir):
        if self.fail_start:
            raise RuntimeError("no device")
        self.started.append(log_dir)

    def stop(self):
        self.stopped += 1


def _capturer(tmp_path, fake, **kw):
    kw.setdefault("default_duration_s", 0.05)
    return ProfileCapturer(base_dir=str(tmp_path), start_fn=fake.start,
                           stop_fn=fake.stop, **kw)


def _wait_stopped(fake):
    deadline = time.monotonic() + 5.0
    while fake.stopped == 0 and time.monotonic() < deadline:
        time.sleep(0.01)


def test_profile_capture_is_single_flight_and_stops_itself(tmp_path):
    fake = FakeProfiler()
    capturer = _capturer(tmp_path, fake)
    first = capturer.capture(trigger="manual")
    assert first["started"] and len(fake.started) == 1
    second = capturer.capture()
    assert not second["started"]
    assert second["reason"] == "capture-in-flight"
    assert len(fake.started) == 1  # the in-flight capture was untouched
    _wait_stopped(fake)
    assert fake.stopped == 1  # the timer stopped it, nobody else had to
    assert capturer.status()["active"] is None
    assert capturer.status()["recent"][0]["completed"]
    assert capturer.capture()["started"]  # single-flight released


def test_profile_duration_clamped_and_errors_degrade(tmp_path):
    fake = FakeProfiler()
    capturer = _capturer(tmp_path, fake, max_duration_s=0.05)
    assert capturer.capture(3600.0)["duration_s"] == 0.05
    broken = _capturer(tmp_path, FakeProfiler(fail_start=True))
    result = broken.capture()
    assert not result["started"]
    assert "profiler-error" in result["reason"]
    assert broken.status()["active"] is None  # nothing leaked open


def test_auto_profile_reason_filter_and_cooldown(tmp_path):
    fake = FakeProfiler()
    capturer = _capturer(tmp_path, fake, cooldown_s=3600.0)
    result = capturer.maybe_capture_auto(["recompile-storm"])
    assert not result["started"]
    assert result["reason"] == "no-latency-shaped-reason"
    assert capturer.maybe_capture_auto(["device-degraded"])["started"]
    _wait_stopped(fake)
    result = capturer.maybe_capture_auto(["device-degraded"])
    assert not result["started"]
    assert result["reason"] == "cooldown"
    # the same reason set as the reference's
    assert port_profiling.AUTO_PROFILE_REASONS == \
        ref_profiling.AUTO_PROFILE_REASONS


def test_torch_profiler_capture_writes_a_trace_and_never_nests(tmp_path):
    """The real profiler behind the default start/stop: a bounded capture
    writes its chrome trace into the capture's directory, a second open
    capture in the process is refused (the capturer reports it as a
    profiler error), and the slot frees once the first one stops."""
    first = ProfileCapturer(base_dir=str(tmp_path / "a"),
                            default_duration_s=0.3)
    second = ProfileCapturer(base_dir=str(tmp_path / "b"),
                             default_duration_s=0.05)
    started = first.capture(trigger="manual")
    assert started["started"], started
    torch.ones(256).sum()  # some work while the capture is open
    refused = second.capture(trigger="manual")
    assert not refused["started"]
    assert "profiler-error" in refused["reason"]
    deadline = time.monotonic() + 30.0
    while first.status()["active"] is not None \
            and time.monotonic() < deadline:
        time.sleep(0.02)
    assert first.status()["recent"][0]["completed"]
    path = os.path.join(started["log_dir"], port_profiling.TRACE_FILE)
    with open(path) as f:
        trace = json.load(f)
    assert isinstance(trace["traceEvents"], list)
    again = second.capture(trigger="manual")
    assert again["started"], again
    while second.status()["active"] is not None \
            and time.monotonic() < deadline:
        time.sleep(0.02)
    assert os.path.exists(os.path.join(again["log_dir"],
                                       port_profiling.TRACE_FILE))


# ------------------------------------------------------ incident recorder


def _verdict(healthy, *reasons):
    return {"healthy": healthy, "status": "ok" if healthy else "degraded",
            "reasons": list(reasons), "degradations": [], "checks": {}}


@PKGS
def test_capture_fires_exactly_on_the_ok_to_degraded_edge(P):
    recorder = P.incident.IncidentRecorder(cooldown_s=0.0)
    recorder.add_collector("evidence", lambda: {"n": 42})
    assert recorder.observe(_verdict(True)) is None
    bundle = recorder.observe(_verdict(False, "fsync-stall"))
    assert bundle is not None
    assert bundle["reasons"] == ["fsync-stall"]
    assert bundle["evidence"] == {"n": 42}
    assert recorder.observe(_verdict(False, "fsync-stall")) is None
    assert len(recorder.bundles()) == 1
    assert recorder.observe(_verdict(True)) is None
    [summary] = recorder.bundles()
    assert summary["recovered_time"] is not None
    assert recorder.observe(_verdict(False, "replication-lag")) is not None
    assert len(recorder.bundles()) == 2


def test_cooldown_suppresses_flapping_and_collector_errors_degrade():
    recorder = IncidentRecorder(cooldown_s=3600.0)

    def boom():
        raise RuntimeError("ring on fire")

    recorder.add_collector("broken", boom)
    assert recorder.observe(_verdict(False, "x")) is not None
    recorder.observe(_verdict(True))
    assert recorder.observe(_verdict(False, "x")) is None  # suppressed
    assert len(recorder.bundles()) == 1
    bundle = recorder.get(recorder.bundles()[0]["id"])
    assert "RuntimeError" in bundle["broken"]["error"]


def test_cooldown_suppressed_edge_captures_after_cooldown_clears():
    recorder = IncidentRecorder(cooldown_s=0.15)
    assert recorder.observe(_verdict(False, "a")) is not None
    recorder.observe(_verdict(True))
    assert recorder.observe(_verdict(False, "b")) is None  # deferred
    assert len(recorder.bundles()) == 1
    time.sleep(0.2)
    bundle = recorder.observe(_verdict(False, "b"))
    assert bundle is not None and bundle["reasons"] == ["b"]
    assert recorder.observe(_verdict(False, "b")) is None
    assert len(recorder.bundles()) == 2
    recorder2 = IncidentRecorder(cooldown_s=0.15)
    recorder2.observe(_verdict(False, "a"))
    recorder2.observe(_verdict(True))
    recorder2.observe(_verdict(False, "b"))  # deferred
    recorder2.observe(_verdict(True))        # recovered: cancel
    time.sleep(0.2)
    assert recorder2.observe(_verdict(True)) is None
    assert len(recorder2.bundles()) == 1


def test_bundles_persist_to_dir_with_bounded_retention(tmp_path):
    incidents_dir = tmp_path / "incidents"
    recorder = IncidentRecorder(capacity=2, cooldown_s=0.0,
                                dir=str(incidents_dir))
    for i in range(4):
        recorder.capture(_verdict(False, f"r{i}"), trigger="manual")
    files = sorted(p.name for p in incidents_dir.glob("inc-*.json"))
    assert files == ["inc-000003.json", "inc-000004.json"]
    with open(incidents_dir / files[-1]) as f:
        assert json.load(f)["reasons"] == ["r3"]
    assert len(recorder.bundles()) == 2


def test_incident_ids_resume_after_restart_across_packages(tmp_path):
    """A restarted process must not recycle ids — including one of the
    other package over the same directory: the bundle files are the
    same."""
    incidents_dir = str(tmp_path / "incidents")
    first = ref_incident.IncidentRecorder(cooldown_s=0.0, dir=incidents_dir)
    first.capture(_verdict(False, "crash-era"), trigger="manual")
    second = IncidentRecorder(cooldown_s=0.0, dir=incidents_dir)
    bundle = second.capture(_verdict(False, "post-boot"), trigger="manual")
    assert bundle["id"] == "inc-000002"
    with open(tmp_path / "incidents" / "inc-000001.json") as f:
        assert json.load(f)["reasons"] == ["crash-era"]  # survived


def test_concurrent_observers_capture_once():
    recorder = IncidentRecorder(cooldown_s=3600.0)
    barrier = threading.Barrier(6)

    def probe():
        barrier.wait()
        recorder.observe(_verdict(False, "device-degraded"))

    threads = [threading.Thread(target=probe) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(recorder.bundles()) == 1


# ------------------------------------------------ end-to-end drill (no REST)


# the compute part of every drill solve, on the rig's clock
DRILL_SOLVE_S = 0.010


class _RigSolveClock:
    """The solve latencies the drill's telemetry observes, on the rig's
    own clock: each solve takes DRILL_SOLVE_S plus what the armed
    `device.solve` delay slept, and that sleep advances this clock, not
    the host's.  On the host's clock a sub-millisecond solve reads ten
    times slower when the host is loaded (0.6, 0.6, 6.6, 7.0 ms beside
    six busy test workers), which the drill's 5x relative floor reads as
    a regression before any fault is armed.

    The latency the matcher measured on the host's clock is still held
    to what load cannot break: it is finite and not negative, and a
    delay is charged to the solve it delayed, its `hit` on the host's
    clock lying between the previous solve's record and this one's."""

    def __init__(self):
        self.slept = 0.0
        self.hits: list[float] = []
        self.recorded_at = time.monotonic()
        self.delayed = 0

    def sleep(self, seconds: float) -> None:
        self.slept += seconds
        self.hits.append(time.monotonic())

    def timed(self, record_match_solve):
        def record(pool, shape, backend, seconds, overlapped=False):
            now = time.monotonic()
            assert math.isfinite(seconds) and seconds >= 0.0, seconds
            assert all(self.recorded_at <= hit <= now
                       for hit in self.hits), (self.recorded_at,
                                               self.hits, now)
            self.delayed += bool(self.hits)
            self.hits, self.recorded_at = [], now
            seconds, self.slept = DRILL_SOLVE_S + self.slept, 0.0
            return record_match_solve(pool, shape, backend, seconds,
                                      overlapped=overlapped)
        return record


def _drill_rig(P):
    """tests/test_incident.py:221 without the REST layer: tight latency
    windows, an injected profiler, auto profile on; solve latencies on
    the rig's clock (`_RigSolveClock`)."""
    clock = FakeClock()
    store = P.store.JobStore(clock=clock)
    store.set_pool(P.ent.Pool(name="default"))
    cluster = P.mock.MockCluster(
        "drill", [P.mock.MockHost(node_id=f"h{i}", hostname=f"h{i}",
                                  mem=8000, cpus=16) for i in range(3)],
        clock=clock)
    scheduler = P.core.Scheduler(store, [cluster], P.core.SchedulerConfig(
        match=P.match(chunk=0), incident_cooldown_s=0.0), **P.kw)
    scheduler.telemetry = P.tel.DeviceTelemetry(
        latency_window=16, latency_recent=2, latency_min_samples=3,
        latency_rel_floor=5.0, update_memory_gauges=False)
    scheduler.telemetry.health_observer = scheduler.incidents.observe
    solve_clock = _RigSolveClock()
    scheduler.telemetry.record_match_solve = solve_clock.timed(
        scheduler.telemetry.record_match_solve)
    fake = FakeProfiler()
    scheduler.profiler = P.profiling.ProfileCapturer(
        base_dir="unused", start_fn=fake.start, stop_fn=fake.stop,
        default_duration_s=0.01, cooldown_s=0.0)
    scheduler.incidents.profiler = scheduler.profiler
    scheduler.incidents.auto_profile = True
    return clock, store, scheduler, fake, solve_clock


def _cycle(P, scheduler, store, clock, n_jobs=2):
    base = f"d-{clock.now_ms}"
    store.submit_jobs([
        P.ent.Job(uuid=f"{base}-{i}", user=f"u{i % 2}", pool="default",
                  command="true", resources=P.ent.Resources(mem=100,
                                                            cpus=0.5),
                  max_retries=5)
        for i in range(n_jobs)])
    pool = store.pools["default"]
    scheduler.rank_cycle(pool)
    scheduler.match_cycle(pool)
    clock.advance(1000)


def _drill(P) -> dict:
    """The acceptance drill of tests/test_incident.py:272, the verdicts
    read from the telemetry instead of GET /debug/health: a `device.solve`
    delay drives health ok -> degraded (`solve-latency-regression`: with
    no fallback ladder the latency guard is the baseline's), ONE bundle is
    captured with the cycle records, the span-ring trace, the armed
    faults, the fairness snapshot and an auto profile; health recovers
    and the bundle is stamped."""
    clock, store, scheduler, fake, solve_clock = _drill_rig(P)
    try:
        for _ in range(6):  # warm the latency baseline
            _cycle(P, scheduler, store, clock)
        assert scheduler.telemetry.health()["status"] == "ok"
        P.faults.arm(P.faults.FaultSchedule([P.faults.FaultRule(
            point=P.faults.DEVICE_SOLVE, mode="delay", delay_s=0.25)],
            sleep=solve_clock.sleep))
        for _ in range(4):
            _cycle(P, scheduler, store, clock)
        assert solve_clock.delayed == 4  # each delayed solve was recorded
        health = scheduler.telemetry.health()
        assert health["status"] == "degraded"
        assert "solve-latency-regression" in health["reasons"]
        [summary] = scheduler.incidents.bundles()
        bundle = scheduler.incidents.get(summary["id"])
        assert bundle["trigger"] == "health-transition"
        assert bundle["verdict"]["status"] == "degraded"
        assert bundle["cycles"], "bundle carries no cycle records"
        assert bundle["trace"]["traceEvents"] is not None
        assert bundle["faults"]["rules"][0]["point"] == "device.solve"
        assert "pools" in bundle["fairness"]
        assert bundle["profile"]["started"] is True
        assert fake.started, "auto profile never reached the profiler"
        P.faults.disarm()
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            _cycle(P, scheduler, store, clock)
            if scheduler.telemetry.health()["status"] == "ok":
                break
        assert scheduler.telemetry.health()["status"] == "ok"
        [summary] = scheduler.incidents.bundles()  # still exactly one
        assert summary["recovered_time"] is not None
        return bundle
    finally:
        P.faults.disarm()


@PKGS
def test_end_to_end_drill_latency_fault_to_bundle_to_recovery(P):
    _drill(P)


def test_drill_bundles_carry_the_reference_evidence():
    """The port's bundle carries every evidence key of the reference's
    scheduler-side bundle (the REST layer's `contention` aside)."""
    assert set(_drill(PORT)) == set(_drill(REF))


# ----------------------------------------------------------- job timeline


def _timeline_run(P):
    """tests/test_incident.py:350 on either package."""
    e = P.ent
    clock = FakeClock()
    store = P.store.JobStore(clock=clock)
    store.set_pool(e.Pool(name="default"))
    cluster = P.mock.MockCluster(
        "tl", [P.mock.MockHost(node_id=f"h{i}", hostname=f"h{i}", mem=1000,
                               cpus=4) for i in range(2)],
        clock=clock, default_runtime_ms=60_000)
    scheduler = P.core.Scheduler(store, [cluster], P.core.SchedulerConfig(
        match=P.match(chunk=0)), **P.kw)
    pool = store.pools["default"]
    store.set_share(e.Share(user="bob", pool="default",
                            resources=e.Resources(mem=1_000_000,
                                                  cpus=1000)))
    store.set_share(e.Share(user="alice", pool="default",
                            resources=e.Resources(mem=100, cpus=1)))

    def cycle():
        scheduler.rank_cycle(pool)
        scheduler.match_cycle(pool)
        clock.advance(1000)

    def job(uuid, user):
        return e.Job(uuid=uuid, user=user, pool="default", command="true",
                     resources=e.Resources(mem=800, cpus=1), max_retries=5)

    store.submit_jobs([job("tl-a", "alice")])
    cycle()
    [task_a] = store.jobs["tl-a"].instance_ids
    host_a = store.instances[task_a].hostname
    store.submit_jobs([job("tl-b1", "bob")])
    cycle()
    store.update_instance_state(task_a, e.InstanceStatus.FAILED,
                                "preempted-by-rebalancer")
    cluster.safe_kill_task(task_a)
    assert store.jobs["tl-a"].state is e.JobState.WAITING
    store.submit_jobs([job("tl-b2", "bob")])
    for _ in range(3):
        cycle()
    assert store.jobs["tl-a"].state is e.JobState.WAITING
    clock.advance(61_000)
    cluster.advance_to(clock.now_ms)
    cycle()
    assert store.jobs["tl-a"].state is e.JobState.RUNNING
    assert store.instances[store.jobs["tl-a"].instance_ids[-1]].hostname \
        != host_a
    running = P.incident.job_timeline(store, scheduler.recorder,
                                      store.jobs["tl-a"])
    clock.advance(61_000)
    cluster.advance_to(clock.now_ms)
    done = P.incident.job_timeline(store, scheduler.recorder,
                                   store.jobs["tl-a"])
    return running, done, store.instances[task_a].end_time_ms


def test_timeline_reconstructs_preempted_lifecycle():
    """The reference's acceptance assertions on the port's timeline, and
    the whole timeline (task ids aside) equal to the reference's."""
    timeline, done, end_a = _timeline_run(PORT)
    kinds = [e["kind"] for e in timeline["events"]]
    for expected in ("submitted", "matched", "launched", "preempted",
                     "re-queued", "waiting"):
        assert expected in kinds, (expected, kinds)
    assert kinds.index("submitted") < kinds.index("matched")
    assert kinds.index("preempted") < kinds.index("re-queued")
    assert kinds.index("re-queued") < kinds.index("waiting")
    assert kinds.count("matched") == 2 and kinds.count("launched") == 2
    [preempted] = [e for e in timeline["events"] if e["kind"] == "preempted"]
    assert preempted["reason"] == "preempted-by-rebalancer"
    assert preempted["mea_culpa"] is True
    attribution = timeline["waiting"]["cycles_by_reason"]
    assert attribution.get("insufficient-resources", 0) >= 3
    [skip_run] = [e for e in timeline["events"] if e["kind"] == "waiting"
                  and e["code"] == "insufficient-resources"]
    assert skip_run["cycles"] >= 3
    assert "cycles skipped: insufficient-resources" in skip_run["summary"]
    assert "last_rank" in skip_run and "last_dru" in skip_run
    assert timeline["phases"]["submit_to_first_match_ms"] == 0
    assert timeline["state"] == "running" and timeline["instances"] == 2
    [requeued] = [e for e in timeline["events"] if e["kind"] == "re-queued"]
    assert requeued["t_ms"] == end_a
    done_kinds = [e["kind"] for e in done["events"]]
    assert done_kinds.count("re-queued") == 1 and "completed" in done_kinds

    def stripped(t):
        """The timeline without its task ids (fresh uuids each run) and
        host-clock stamps."""
        return json.loads(json.dumps(t, default=str), object_hook=lambda d: {
            k: v for k, v in d.items()
            if k not in ("task_id", "task", "wall_time")})

    want, want_done, _ = _timeline_run(REF)
    assert stripped(timeline) == stripped(want)
    assert stripped(done) == stripped(want_done)


@PKGS
def test_job_history_is_bounded_and_ordered(P):
    recorder = P.flight.FlightRecorder(history_per_job=4)
    for i in range(10):
        builder = recorder.begin("default", t_ms=i * 1000)
        builder.note_skip("job-x", "insufficient-resources")
        recorder.commit(builder)
    history = recorder.job_history("job-x")
    assert len(history) == 4
    cycles = [e["cycle"] for e in history]
    assert cycles == sorted(cycles) and cycles[-1] == 10
    assert all(e["t_ms"] == (e["cycle"] - 1) * 1000 for e in history)
    assert recorder.job_history("never-seen") == []


@PKGS
def test_job_history_lru_bounds_job_count(P):
    recorder = P.flight.FlightRecorder(job_reason_capacity=5)
    builder = recorder.begin("default", t_ms=0)
    for i in range(20):
        builder.note_skip(f"job-{i}", "no-offers")
    recorder.commit(builder)
    tracked = sum(1 for i in range(20) if recorder.job_history(f"job-{i}"))
    assert tracked == 5
    assert recorder.job_history("job-19")
