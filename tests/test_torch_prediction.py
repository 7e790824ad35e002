"""Runtime prediction and speculative match cycles of `cook_tpu_torch`
against `cook_tpu` on the CPU: the ports of tests/test_prediction.py's
cases (all but the REST endpoint's), each run on both packages (`ref` /
`port`) with the reference's assertions, and their decisions compared:

- the predictor (cold start, single sample, outliers, quantile order,
  window, LRU bound, fingerprints, feeding from the store) and a seeded
  fuzz of its estimates, equal to 1e-9 relative;
- the speculation guard's event algebra and pool scoping;
- speculative cycles end to end (hit, epoch-stale race, prediction miss,
  the estimated-completion constraint, the kill switch, offers changed,
  pipelined, hit = fresh placements): run placements, every cycle
  record's `speculation`, `speculation_drop` and `backend`, and the
  speculator's `stats_json` counts equal;
- the simulator A/B (the completion-heavy wave, the standard trace), the
  wave with three users on both rank paths (the columnar rank breaks
  equal-DRU ties in another user order than the speculator's
  `rank_pool`, so most speculations drop `queue-shifted`: a reference
  fault reproduced, ROADMAP Queue C), and `pre_launch_ms`;
- the backfill term (`dru_rank`, `rank_pool`) and `estimated_end_times`;
- tests/test_data_plane.py:252 (a hit cycle moves no H2D bytes) and
  tests/test_constraints_extended.py:84-112 (the estimated-completion
  constraint on the match path)."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cook_tpu.cluster import mock as ref_mock
from cook_tpu.models import entities as ref_ent
from cook_tpu.models import store as ref_store
from cook_tpu.obs import data_plane as ref_dp
from cook_tpu.ops import dru as ref_dru
from cook_tpu.scheduler import core as ref_core
from cook_tpu.scheduler import matcher as ref_matcher
from cook_tpu.scheduler import prediction as ref_pred
from cook_tpu.scheduler import ranking as ref_ranking
from cook_tpu.sim import loadgen as ref_loadgen
from cook_tpu.sim import simulator as ref_sim
from cook_tpu_torch.cluster import mock as port_mock
from cook_tpu_torch.models import entities as port_ent
from cook_tpu_torch.models import store as port_store
from cook_tpu_torch.obs import data_plane as port_dp
from cook_tpu_torch.ops import dru as port_dru
from cook_tpu_torch.scheduler import core as port_core
from cook_tpu_torch.scheduler import matcher as port_matcher
from cook_tpu_torch.scheduler import prediction as port_pred
from cook_tpu_torch.scheduler import ranking as port_ranking
from cook_tpu_torch.sim import loadgen as port_loadgen
from cook_tpu_torch.sim import simulator as port_sim
from tests.conftest import FakeClock

# one intra-op thread: the suite runs several pytest-xdist workers side
# by side, and idle OpenMP threads spinning in each would crowd them
torch.set_num_threads(1)

REF = SimpleNamespace(name="ref", ent=ref_ent, store=ref_store,
                      mock=ref_mock, core=ref_core, matcher=ref_matcher,
                      pred=ref_pred, ranking=ref_ranking, sim=ref_sim,
                      loadgen=ref_loadgen, dp=ref_dp, kw={})
PORT = SimpleNamespace(name="port", ent=port_ent, store=port_store,
                       mock=port_mock, core=port_core, matcher=port_matcher,
                       pred=port_pred, ranking=port_ranking, sim=port_sim,
                       loadgen=port_loadgen, dp=port_dp,
                       kw={"device": "cpu"})
PKGS = pytest.mark.parametrize("P", [REF, PORT], ids=["ref", "port"])


def _job(P, uuid, user="u0", pool="default", mem=1000.0, cpus=4.0,
         **kw):
    e = P.ent
    kw.setdefault("command", "true")
    return e.Job(uuid=uuid, user=user, pool=pool, priority=50,
                 max_retries=1, resources=e.Resources(mem=mem, cpus=cpus),
                 **kw)


# ----------------------------------------------------------- the predictor


@PKGS
def test_predictor_cold_start_returns_none(P):
    p = P.pred.QuantileRuntimePredictor(min_samples=3)
    assert p.predict_runtime_ms("u", "train.py") is None
    p.observe("u", "train.py", 1000)
    p.observe("u", "train.py", 1000)
    assert p.predict_runtime_ms("u", "train.py") is None  # 2 < min_samples
    p.observe("u", "train.py", 1000)
    assert p.predict_runtime_ms("u", "train.py") == pytest.approx(1000)


@PKGS
def test_predictor_single_sample_when_allowed(P):
    p = P.pred.QuantileRuntimePredictor(min_samples=1)
    p.observe("u", "cmd", 4200)
    assert p.predict_runtime_ms("u", "cmd") == pytest.approx(4200)


@PKGS
def test_predictor_outlier_robustness(P):
    p = P.pred.QuantileRuntimePredictor(min_samples=3)
    for _ in range(9):
        p.observe("u", "cmd", 100)
    p.observe("u", "cmd", 1_000_000)
    assert p.predict_runtime_ms("u", "cmd", quantile=0.5) \
        == pytest.approx(100)
    assert p.predict_runtime_ms("u", "cmd") <= 200


@PKGS
def test_predictor_quantile_monotonicity(P):
    p = P.pred.QuantileRuntimePredictor(min_samples=3)
    for v in (100, 200, 300, 400, 500, 600, 700, 800):
        p.observe("u", "cmd", v)
    estimates = [p.predict_runtime_ms("u", "cmd", quantile=q)
                 for q in (0.1, 0.25, 0.5, 0.75, 0.9, 1.0)]
    assert estimates == sorted(estimates)
    assert estimates[-1] == pytest.approx(800)


@PKGS
def test_predictor_window_evicts_old_samples(P):
    p = P.pred.QuantileRuntimePredictor(min_samples=1, window=4)
    for _ in range(10):
        p.observe("u", "cmd", 10_000)
    for _ in range(4):
        p.observe("u", "cmd", 100)
    assert p.predict_runtime_ms("u", "cmd") == pytest.approx(100)


@PKGS
def test_predictor_key_lru_bound(P):
    p = P.pred.QuantileRuntimePredictor(min_samples=1, max_keys=3)
    for i in range(6):
        p.observe(f"u{i}", "cmd", 100)
    assert len(p._samples) == 3
    assert p.predict_runtime_ms("u0", "cmd") is None  # evicted
    assert p.predict_runtime_ms("u5", "cmd") is not None
    assert p.stats_json()["keys"] == 3


def test_command_fingerprint_distinguishes_commands():
    for cmd in ("train.py --lr 1e-3", "train.py --lr 3e-4", "", " ",
                "\t\n", "x" * 80 + " --flag"):
        assert port_pred.command_fingerprint(cmd) \
            == ref_pred.command_fingerprint(cmd)
    f = port_pred.command_fingerprint
    assert f("train.py --lr 1e-3") != f("train.py --lr 3e-4")
    assert f("").startswith("#") and f(" ").startswith("#")
    assert f("\t\n").startswith("#")
    p = port_pred.QuantileRuntimePredictor(min_samples=1)
    p.observe("u", " ", 500)
    assert p.predict_runtime_ms("u", " ") == pytest.approx(500)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_predictor_estimates_equal_the_reference(seed):
    """A seeded stream of observations over a few keys (runtimes of
    several magnitudes, some non-positive and dropped, a window and an
    LRU bound that evict): every key's estimate at several quantiles
    equal to 1e-9 relative, cold keys cold in both, and equal stats."""
    rng = np.random.default_rng(seed)
    kw = dict(quantile=float(rng.choice([0.5, 0.75, 0.9])),
              window=int(rng.integers(4, 16)),
              min_samples=int(rng.integers(1, 4)), max_keys=6)
    preds = [P.pred.QuantileRuntimePredictor(**kw) for P in (REF, PORT)]
    users = [f"u{i}" for i in range(4)]
    commands = ["train.py --lr 1e-3", "train.py --lr 3e-4", "etl.sh", ""]
    for _ in range(300):
        user = users[int(rng.integers(len(users)))]
        cmd = commands[int(rng.integers(len(commands)))]
        runtime = float(rng.lognormal(10.0, 1.5)) * float(
            rng.choice([1.0, 1.0, 1.0, -1.0, 0.0]))
        for p in preds:
            p.observe(user, cmd, runtime)
    assert preds[0].stats_json() == preds[1].stats_json()
    seen = 0
    for user in users:
        for cmd in commands:
            for q in (None, 0.1, 0.5, 0.99, 1.0):
                ref, port = (p.predict_runtime_ms(user, cmd, quantile=q)
                             for p in preds)
                assert (ref is None) == (port is None)
                if ref is not None:
                    seen += 1
                    assert port == pytest.approx(ref, rel=1e-9)
    assert seen > 0


@PKGS
def test_predictor_feeds_from_store_completions(P):
    clock = FakeClock()
    store = P.store.JobStore(clock=clock)
    store.set_pool(P.ent.Pool(name="default"))
    p = P.pred.QuantileRuntimePredictor(min_samples=1).attach(store)
    store.submit_jobs([_job(P, "j1", user="alice", command="run.sh")])
    store.create_instance("j1", "t1", hostname="h0")
    clock.advance(7000)
    store.update_instance_state("t1", P.ent.InstanceStatus.SUCCESS,
                                "normal-exit")
    assert p.predict_runtime_ms("alice", "run.sh") == pytest.approx(7000)
    # a failed instance is not a runtime observation
    store.submit_jobs([_job(P, "j2", user="alice", command="run.sh")])
    store.create_instance("j2", "t2", hostname="h0")
    clock.advance(1000)
    store.update_instance_state("t2", P.ent.InstanceStatus.FAILED,
                                "killed-by-user")
    assert p.stats_json()["observations"] == 1


# --------------------------------------------------------------- the guard


def _event(P, kind, data):
    return P.store.Event(seq=0, kind=kind, data=data)


@PKGS
def test_guard_unexpected_event_marks_stale(P):
    g = P.pred.SpeculationGuard()
    token = g.begin("default")
    g.expect(token, [("instance/status", "t1", "success")])
    g._on_event(_event(P, "quota/set", {"user": "u"}))
    ok, reason = g.finish(token)
    assert not ok and reason == P.pred.DROP_EPOCH_STALE


@PKGS
def test_guard_expected_completion_confirms(P):
    g = P.pred.SpeculationGuard()
    token = g.begin("default")
    g.expect(token, [("instance/status", "t1", "success"),
                     ("job/state", "j1", "completed")])
    g._on_event(_event(P, "instance/status",
                       {"task_id": "t1", "status": "success"}))
    g._on_event(_event(P, "job/state", {"uuid": "j1", "state": "completed"}))
    assert g.finish(token) == (True, "")


@PKGS
def test_guard_missing_confirmation_is_prediction_miss(P):
    g = P.pred.SpeculationGuard()
    token = g.begin("default")
    g.expect(token, [("instance/status", "t1", "success")])
    ok, reason = g.finish(token)
    assert not ok and reason == P.pred.DROP_PREDICTION_MISS
    # a retired (or unknown) token never commits
    assert g.finish(token) == (False, P.pred.DROP_EPOCH_STALE)


@PKGS
def test_guard_assumed_task_failing_is_stale(P):
    g = P.pred.SpeculationGuard()
    token = g.begin("default")
    g.expect(token, [("instance/status", "t1", "success")])
    g._on_event(_event(P, "instance/status",
                       {"task_id": "t1", "status": "failed"}))
    ok, reason = g.finish(token)
    assert not ok and reason == P.pred.DROP_EPOCH_STALE


@PKGS
def test_guard_pool_scoping(P):
    clock = FakeClock()
    store = P.store.JobStore(clock=clock)
    store.set_pool(P.ent.Pool(name="a"))
    store.set_pool(P.ent.Pool(name="b"))
    store.submit_jobs([_job(P, "other", pool="b", mem=100.0, cpus=1.0)])
    g = P.pred.SpeculationGuard(store)
    token = g.begin("a")
    g._on_event(_event(P, "job/state", {"uuid": "other",
                                        "state": "completed"}))
    assert g.finish(token)[0], "pool b's event must not veto pool a"
    token = g.begin("a")
    g._on_event(_event(P, "pool/capacity", {"uuid": "x"}))
    assert g.finish(token) == (False, P.pred.DROP_EPOCH_STALE)


# ------------------------------------------------- speculative cycles (e2e)


def one_host_scenario(P, n_jobs=3, runtime_ms=10_000, residency=False,
                      **config_kw):
    """tests/test_prediction.py:194: one 1000 MB / 4 cpu host, jobs that
    fill it, each running `runtime_ms`, the horizon one wave."""
    clock = FakeClock()
    store = P.store.JobStore(clock=clock)
    store.set_pool(P.ent.Pool(name="default"))
    cluster = P.mock.MockCluster(
        "mock", [P.mock.MockHost(node_id="h0", hostname="h0", mem=1000,
                                 cpus=4, pool="default")], clock=clock)
    match = P.matcher.MatchConfig(chunk=0, device_residency=residency)
    scheduler = P.core.Scheduler(store, [cluster], P.core.SchedulerConfig(
        match=match, speculation=True, speculation_horizon_ms=runtime_ms,
        predictor_min_samples=1, **config_kw), **P.kw)
    store.submit_jobs([_job(P, f"j{i}", expected_runtime_ms=runtime_ms)
                       for i in range(n_jobs)])
    return clock, store, cluster, scheduler


def run_cycle(scheduler, store, pool="default"):
    pool = store.pools[pool]
    scheduler.rank_cycle(pool)
    outcome = scheduler.match_cycle(pool)
    return outcome, scheduler.recorder.records(limit=1)[0]


def advance_wave(clock, cluster, ms=10_000):
    clock.advance(ms)
    cluster.advance_to(clock())


def _view(outcome, record):
    """A cycle's decisions: matches and the record's speculation
    fields."""
    return ([(j.uuid, o.hostname) for j, o in outcome.matched],
            record.speculation, record.speculation_drop, record.speculative,
            record.backend)


def _stats(scheduler):
    return {k: v for k, v in scheduler.speculator.stats_json().items()}


def _both(scenario):
    """Run `scenario(P)` on both packages; their results must be equal.
    Returns the port's."""
    ref, port = scenario(REF), scenario(PORT)
    assert port == ref
    return port


def test_speculative_cycle_hit_end_to_end():
    def scenario(P):
        clock, store, cluster, scheduler = one_host_scenario(P)
        out1, r1 = run_cycle(scheduler, store)     # j0 fresh; cold
        assert r1.speculation == "none"
        advance_wave(clock, cluster)               # j0 completes
        out2, r2 = run_cycle(scheduler, store)     # j1 fresh; speculates j2
        assert r2.speculation == "none"
        assert r2.speculation_drop == P.pred.DROP_PREDICTOR_COLD
        advance_wave(clock, cluster)               # j1 completes
        out3, r3 = run_cycle(scheduler, store)     # served from speculation
        assert r3.speculation == "hit" and r3.speculative
        assert [j.uuid for j, _ in out3.matched] == ["j2"]
        assert "tensor_build" not in r3.phases and "solve" not in r3.phases
        assert "speculation_commit" in r3.phases
        assert r3.backend.startswith("spec-")
        stats = _stats(scheduler)
        assert stats["hits"] == 1 and stats["dropped"] == 0
        return ([_view(o, r) for o, r in ((out1, r1), (out2, r2),
                                          (out3, r3))], stats)

    _both(scenario)


def test_epoch_stale_speculation_never_commits():
    """A store mutation landing between speculative dispatch and commit
    vetoes the commit: dropped epoch-stale, and the fresh solve sees the
    mutated state."""
    def scenario(P):
        clock, store, cluster, scheduler = one_host_scenario(P)
        run_cycle(scheduler, store)
        advance_wave(clock, cluster)
        run_cycle(scheduler, store)
        assert _stats(scheduler)["inflight"] == ["default"]
        store.submit_jobs([_job(P, "late", user="u9", mem=100, cpus=1)])
        advance_wave(clock, cluster)
        out3, r3 = run_cycle(scheduler, store)
        assert r3.speculation == "dropped"
        assert r3.speculation_drop == P.pred.DROP_EPOCH_STALE
        assert not r3.speculative
        assert "late" in {j.uuid for j, _ in out3.matched}
        stats = _stats(scheduler)
        assert stats["drop_reasons"] == {P.pred.DROP_EPOCH_STALE: 1}
        return _view(out3, r3), stats

    _both(scenario)


def test_prediction_miss_drops_instead_of_committing():
    def scenario(P):
        clock, store, cluster, scheduler = one_host_scenario(P)
        run_cycle(scheduler, store)
        advance_wave(clock, cluster)
        run_cycle(scheduler, store)
        assert _stats(scheduler)["inflight"] == ["default"]
        advance_wave(clock, cluster, ms=2000)   # the completion not yet in
        out3, r3 = run_cycle(scheduler, store)
        assert r3.speculation == "dropped"
        assert r3.speculation_drop == P.pred.DROP_PREDICTION_MISS
        assert not out3.matched
        return _view(out3, r3), _stats(scheduler)

    _both(scenario)


def test_no_speculation_while_completion_constraint_active():
    def scenario(P):
        clock, store, cluster, scheduler = one_host_scenario(P)
        scheduler.config.match.completion_multiplier = 1.5
        scheduler.config.match.host_lifetime_mins = 100.0
        views = [_view(*run_cycle(scheduler, store))]
        advance_wave(clock, cluster)
        views.append(_view(*run_cycle(scheduler, store)))
        stats = _stats(scheduler)
        assert stats["inflight"] == [] and stats["dispatched"] == 0
        return views, stats

    _both(scenario)


def test_disabled_kill_switch_drops_inflight():
    def scenario(P):
        clock, store, cluster, scheduler = one_host_scenario(P)
        run_cycle(scheduler, store)
        advance_wave(clock, cluster)
        run_cycle(scheduler, store)
        scheduler.speculator.enabled = False
        advance_wave(clock, cluster)
        out3, r3 = run_cycle(scheduler, store)
        assert r3.speculation == "dropped"
        assert r3.speculation_drop == "disabled"
        # the fresh solve still placed the next job
        assert [j.uuid for j, _ in out3.matched] == ["j2"]
        return _view(out3, r3), _stats(scheduler)

    _both(scenario)


def test_offers_changed_drops():
    def scenario(P):
        clock, store, cluster, scheduler = one_host_scenario(P, n_jobs=4)
        run_cycle(scheduler, store)
        advance_wave(clock, cluster)
        run_cycle(scheduler, store)
        assert _stats(scheduler)["inflight"] == ["default"]
        host = P.mock.MockHost(node_id="h1", hostname="h1", mem=1000,
                               cpus=4, pool="default")
        cluster.hosts[host.node_id] = host   # no store event fires
        advance_wave(clock, cluster)
        out3, r3 = run_cycle(scheduler, store)
        assert r3.speculation == "dropped"
        assert r3.speculation_drop == "offers-changed"
        return _view(out3, r3), _stats(scheduler)

    _both(scenario)


def pipelined_rig(P, n_pools=2, speculation=True):
    clock = FakeClock()
    store = P.store.JobStore(clock=clock)
    hosts = []
    for p in range(n_pools):
        store.set_pool(P.ent.Pool(name=f"pool{p}"))
        hosts.append(P.mock.MockHost(node_id=f"p{p}h0", hostname=f"p{p}h0",
                                     mem=1000, cpus=4, pool=f"pool{p}"))
    cluster = P.mock.MockCluster("mock", hosts, clock=clock)
    scheduler = P.core.Scheduler(store, [cluster], P.core.SchedulerConfig(
        match=P.matcher.MatchConfig(chunk=0), speculation=speculation,
        speculation_horizon_ms=10_000, predictor_min_samples=1), **P.kw)
    store.submit_jobs([_job(P, f"p{p}j{i}", pool=f"pool{p}",
                            expected_runtime_ms=10_000)
                       for p in range(n_pools) for i in range(3)])
    return clock, store, cluster, scheduler


def test_pipelined_speculation_hit():
    def scenario(P):
        clock, store, cluster, scheduler = pipelined_rig(P)
        pools = list(store.pools.values())

        def pcycle():
            for pool in pools:
                scheduler.rank_cycle(pool)
            outcomes = scheduler.match_cycle_pipelined()
            records = sorted(scheduler.recorder.records(limit=2),
                             key=lambda r: r.pool)
            return ([(name, sorted(j.uuid for j, _ in o.matched))
                     for name, o in sorted(outcomes.items())],
                    [(r.pool, r.speculation, r.speculation_drop,
                      r.backend, r.pipelined) for r in records])

        views = [pcycle()]
        advance_wave(clock, cluster)
        views.append(pcycle())
        advance_wave(clock, cluster)
        views.append(pcycle())
        for _pool, spec, _drop, backend, pipelined in views[-1][1]:
            # one pool's predicted completions must not veto the other's
            # speculation (pool-scoped guard)
            assert spec == "hit" and pipelined
            assert backend.startswith("spec-")
        for p in range(2):
            assert store.jobs[f"p{p}j2"].state.value == "running"
        return views, _stats(scheduler)

    _both(scenario)


def test_speculative_hit_placements_equal_fresh_solve():
    """A committed speculation's placements equal what a fresh solve at
    cycle N+1 would have produced: the scenario with speculation on and
    off, in both packages."""
    def scenario(P, speculation):
        clock = FakeClock()
        store = P.store.JobStore(clock=clock)
        store.set_pool(P.ent.Pool(name="default"))
        cluster = P.mock.MockCluster(
            "mock", [P.mock.MockHost(node_id=f"h{i}", hostname=f"h{i}",
                                     mem=1000, cpus=4, pool="default")
                     for i in range(2)], clock=clock)
        scheduler = P.core.Scheduler(store, [cluster], P.core.SchedulerConfig(
            match=P.matcher.MatchConfig(chunk=0), speculation=speculation,
            speculation_horizon_ms=10_000, predictor_min_samples=1), **P.kw)
        store.submit_jobs([_job(P, f"j{i}", user=f"u{i % 2}",
                                expected_runtime_ms=10_000)
                           for i in range(8)])
        placements, specs = [], []
        for _ in range(6):
            out, rec = run_cycle(scheduler, store)
            placements.extend((j.uuid, o.hostname) for j, o in out.matched)
            specs.append((rec.speculation, rec.speculation_drop))
            advance_wave(clock, cluster)
        return placements, specs

    results = {P.name: {on: scenario(P, on) for on in (True, False)}
               for P in (REF, PORT)}
    assert results["port"] == results["ref"]
    assert results["port"][True][0] == results["port"][False][0]


# ------------------------------------------------------------- A/B (sim)


def completion_heavy_results(P, speculate, jobs=24, hosts=4, n_users=1,
                             seed=0, columnar=True, cycles=40):
    trace_jobs, trace_hosts = P.loadgen.completion_heavy_trace(
        jobs=jobs, hosts=hosts, n_users=n_users, seed=seed)
    config = P.sim.SimConfig(
        cycle_ms=30_000, max_cycles=cycles, speculate=speculate,
        scheduler=P.core.SchedulerConfig(device_telemetry=False,
                                         use_columnar_index=columnar))
    return P.sim.Simulator(trace_jobs, trace_hosts, config, **P.kw).run()


def _placements(result):
    return sorted((r["job_uuid"], r["start_ms"], r["host"])
                  for r in result.rows if r["start_ms"] is not None)


def _spec_records(result):
    return [(r["cycle"], r.get("speculation"), r.get("speculation_drop"),
             r.get("backend")) for r in result.cycle_records]


def _hits_and_latency(stats):
    """speculation_stats less the pre-launch p50 (a host wall)."""
    return {k: v for k, v in stats.items() if k != "pre_launch_p50_ms"}


def test_ab_completion_heavy_speculation():
    """>= 20% of cycles served from speculation and a lower cycle-start-
    to-first-launch p50, with identical placements — in both packages,
    the port's run trace, records and hit counts equal to the
    reference's."""
    out = {}
    for P in (REF, PORT):
        base = completion_heavy_results(P, False)
        spec = completion_heavy_results(P, True)
        b, s = base.speculation_stats(), spec.speculation_stats()
        assert b["hits"] == 0
        assert s["hit_fraction"] >= 0.2, s
        assert s["pre_launch_p50_ms"] < b["pre_launch_p50_ms"], (s, b)
        assert _placements(base) == _placements(spec)
        out[P.name] = (base.to_csv(), spec.to_csv(), _spec_records(spec),
                       _hits_and_latency(s))
    assert out["port"] == out["ref"]


def test_ab_standard_trace_identical_placements():
    """On the standard synthetic trace (varied runtimes — predictions
    routinely miss), speculation changes NO placement; the port's runs
    equal the reference's, drop for drop."""
    out = {}
    for P in (REF, PORT):
        runs = {}
        for speculate in (True, False):
            jobs, hosts = P.sim.synth_trace(40, 6, n_users=4, seed=3,
                                            mean_runtime_ms=45_000)
            config = P.sim.SimConfig(
                cycle_ms=30_000, max_cycles=60, speculate=speculate,
                scheduler=P.core.SchedulerConfig(device_telemetry=False))
            result = P.sim.Simulator(jobs, hosts, config, **P.kw).run()
            runs[speculate] = (_placements(result), _spec_records(result))
        assert runs[True][0] == runs[False][0]
        out[P.name] = runs
    assert out["port"] == out["ref"]


# the completion-heavy wave at 48 jobs on 4 hosts (seed 1), per (users,
# rank path): hits of the job-considering cycles and the drop reasons.
# With three users the columnar rank breaks equal-DRU ties in first-seen
# user order and the speculator's rank_pool alphabetically, so the
# commit's ordered window check drops most speculations: the reference's
# behaviour (ROADMAP Queue C reference item 7), reproduced
WAVE_USERS = {
    (1, True): (10, 12, {}),
    (1, False): (10, 12, {}),
    (3, True): (1, 12, {"queue-shifted": 7, "epoch-stale": 1}),
    (3, False): (8, 12, {"epoch-stale": 1}),
}


@pytest.mark.parametrize("users,columnar", sorted(WAVE_USERS),
                         ids=[f"{u}users-{'columnar' if c else 'object'}"
                              for u, c in sorted(WAVE_USERS)])
def test_multi_user_wave_drop_reasons_match_the_reference(users, columnar):
    hits, cycles, drops = WAVE_USERS[(users, columnar)]
    out = {}
    for P in (REF, PORT):
        result = completion_heavy_results(P, True, jobs=48, n_users=users,
                                          seed=1, columnar=columnar)
        stats = result.speculation_stats()
        assert (stats["hits"], stats["cycles"]) == (hits, cycles)
        reasons = {}
        for r in result.cycle_records:
            if r.get("speculation") == "dropped":
                reasons[r["speculation_drop"]] = \
                    reasons.get(r["speculation_drop"], 0) + 1
        assert reasons == drops
        out[P.name] = (result.to_csv(), _spec_records(result))
    assert out["port"] == out["ref"]
    # placements never depend on speculation: a dropped one solves fresh
    base = completion_heavy_results(PORT, False, jobs=48, n_users=users,
                                    seed=1, columnar=columnar)
    assert base.to_csv() == out["port"][0]


def test_pre_launch_ms_helper():
    record = {"phases": {"rank": 1.0, "tensor_build": 0.002,
                         "solve": 0.003, "launch": 0.5}}
    assert port_pred.pre_launch_ms(record) == pytest.approx(5.0)
    assert port_pred.pre_launch_ms(record) == ref_pred.pre_launch_ms(record)
    assert port_pred.PRE_LAUNCH_PHASES == ref_pred.PRE_LAUNCH_PHASES


# -------------------------------------------------- backfill scoring term


def test_dru_backfill_reorders_within_bound():
    import jax.numpy as jnp

    def both(mem, backfill=None, weight=None):
        ref = ref_dru.dru_rank(
            ref_dru.DruTasks(
                user=jnp.asarray([0, 1], dtype=jnp.int32),
                mem=jnp.asarray(mem), cpus=jnp.asarray([1.0, 1.0]),
                gpus=jnp.zeros(2), order_key=jnp.asarray([0.0, 1.0]),
                valid=jnp.asarray([True, True])),
            *(jnp.asarray([1000.0, 1000.0]),) * 3,
            backfill=None if backfill is None else jnp.asarray(backfill),
            backfill_weight=None if weight is None else jnp.float32(weight))
        port = port_dru.dru_rank(
            port_dru.from_numpy([0, 1], mem, [1.0, 1.0], [0.0, 0.0],
                                [0.0, 1.0], [True, True], device="cpu"),
            *(torch.tensor([1000.0, 1000.0]),) * 3,
            backfill=(None if backfill is None
                      else torch.tensor(backfill, dtype=torch.float32)),
            backfill_weight=weight)
        assert list(port.order.numpy()) == list(np.asarray(ref.order))
        np.testing.assert_array_equal(port.dru.numpy(), np.asarray(ref.dru))
        return port

    plain = both([100.0, 100.0])
    assert list(plain.order.numpy()) == [0, 1]
    # task 1 predicted short (frac 0.1), task 0 long (frac 1.0)
    adjusted = both([100.0, 100.0], [1.0, 0.1], 0.05)
    assert list(adjusted.order.numpy()) == [1, 0]
    # the raw dru column is not rewritten by the term
    np.testing.assert_array_equal(adjusted.dru.numpy(), plain.dru.numpy())
    # bounded: a materially lower-DRU task cannot be jumped
    adjusted2 = both([100.0, 900.0], [1.0, 0.0], 0.05)
    assert list(adjusted2.order.numpy()) == [0, 1]


@PKGS
def test_rank_pool_backfill_prefers_predicted_short_jobs(P):
    clock = FakeClock()
    store = P.store.JobStore(clock=clock)
    store.set_pool(P.ent.Pool(name="default"))
    store.submit_jobs([
        _job(P, "long", user="a", mem=100, cpus=1, command="long.sh"),
        _job(P, "short", user="b", mem=100, cpus=1, command="short.sh")])
    predictor = P.pred.QuantileRuntimePredictor(min_samples=1)
    predictor.observe("a", "long.sh", 600_000)
    predictor.observe("b", "short.sh", 10_000)
    pool = store.pools["default"]
    plain = P.ranking.rank_pool(store, pool, **P.kw)
    assert [j.uuid for j in plain.jobs] == ["long", "short"]
    boosted = P.ranking.rank_pool(store, pool, predictor=predictor,
                                  backfill_weight=0.05,
                                  backfill_norm_ms=600_000, **P.kw)
    assert [j.uuid for j in boosted.jobs] == ["short", "long"]
    assert boosted.dru == plain.dru
    zero = P.ranking.rank_pool(store, pool, predictor=predictor,
                               backfill_weight=0.0, **P.kw)
    assert [j.uuid for j in zero.jobs] == [j.uuid for j in plain.jobs]


def _backfill_rig(P, seed):
    """A seeded queue of 4 users' jobs over a few commands, some of them
    running, and a predictor warm on most (user, command) keys."""
    rng = np.random.default_rng(seed)
    clock = FakeClock()
    store = P.store.JobStore(clock=clock)
    store.set_pool(P.ent.Pool(name="default"))
    jobs = []
    for i in range(60):
        jobs.append(_job(
            P, f"j{i:02d}", user=f"u{int(rng.integers(4))}",
            mem=float(rng.choice([512, 1024, 2048])),
            cpus=float(rng.choice([1.0, 2.0])),
            command=f"cmd{int(rng.integers(5))}.sh"))
    store.submit_jobs(jobs)
    for i in range(0, 60, 7):
        store.create_instance(f"j{i:02d}", f"t{i}", hostname="h0")
    predictor = P.pred.QuantileRuntimePredictor(min_samples=1)
    for _ in range(40):
        predictor.observe(f"u{int(rng.integers(4))}",
                          f"cmd{int(rng.integers(4))}.sh",
                          float(rng.integers(1_000, 900_000)))
    return store, predictor


@pytest.mark.parametrize("weight", [0.0, 0.01, 0.2])
def test_rank_pool_backfill_order_equals_the_reference(weight):
    """The backfill term on a seeded multi-user queue: the port's rank
    order and DRU map equal the reference's at each weight."""
    out = {}
    for P in (REF, PORT):
        store, predictor = _backfill_rig(P, seed=4)
        queue = P.ranking.rank_pool(store, store.pools["default"],
                                    predictor=predictor,
                                    backfill_weight=weight,
                                    backfill_norm_ms=300_000, **P.kw)
        out[P.name] = ([j.uuid for j in queue.jobs], queue.dru)
    assert out["port"] == out["ref"]


def test_backfill_rank_cycle_routes_through_rank_pool():
    """With a backfill weight the rank cycle runs rank_pool (the columnar
    fast path has no duration column) even with the columnar index on,
    in both packages: equal queues."""
    out = {}
    for P in (REF, PORT):
        store, _ = _backfill_rig(P, seed=5)
        cluster = P.mock.MockCluster("m", [P.mock.MockHost(
            node_id="h0", hostname="h0", mem=65536, cpus=32,
            pool="default")], clock=store.clock)
        scheduler = P.core.Scheduler(store, [cluster], P.core.SchedulerConfig(
            backfill_weight=0.05), **P.kw)
        assert scheduler._backfill_active
        assert scheduler.columnar is not None
        for _ in range(6):
            scheduler.predictor.observe("u1", "cmd2.sh", 5_000)
        queue = scheduler.rank_cycle(store.pools["default"])
        out[P.name] = [j.uuid for j in queue.jobs]
    assert out["port"] == out["ref"]


# ------------------------------------------- the estimated-completion rule


@PKGS
def test_estimated_end_times_uses_predictor(P):
    clock = FakeClock()
    store = P.store.JobStore(clock=clock)
    store.set_pool(P.ent.Pool(name="default"))
    job = _job(P, "noest", user="a", mem=100, cpus=1, command="run.sh",
               expected_runtime_ms=0)
    store.submit_jobs([job])
    config = P.matcher.MatchConfig(completion_multiplier=1.5,
                                   host_lifetime_mins=100.0)
    assert P.matcher.estimated_end_times(store, [job], config)[0] == -1.0
    predictor = P.pred.QuantileRuntimePredictor(min_samples=1)
    predictor.observe("a", "run.sh", 60_000)
    est = P.matcher.estimated_end_times(store, [job], config,
                                        predictor=predictor)
    assert est[0] == pytest.approx(clock() + 90_000)
    # the constraint off: no estimates at all
    assert P.matcher.estimated_end_times(
        store, [job], P.matcher.MatchConfig()) is None


def test_estimated_end_times_equal_the_reference():
    """Seeded jobs (declared runtimes, none, predictor-filled), some with
    an instance that died with its host (node-removed) after a long run,
    others failed otherwise; capped at lifetime - grace: equal estimates,
    and the agent-removed reason codes equal."""
    assert port_matcher.AGENT_REMOVED_CODES == ref_matcher.AGENT_REMOVED_CODES
    out = {}
    for P in (REF, PORT):
        rng = np.random.default_rng(7)
        clock = FakeClock()
        store = P.store.JobStore(clock=clock)
        store.set_pool(P.ent.Pool(name="default"))
        jobs = [_job(P, f"j{i}", user=f"u{i % 2}", mem=100, cpus=1,
                     command=f"c{i % 3}",
                     expected_runtime_ms=int(rng.choice(
                         [0, 60_000, 3_000_000, 9_000_000])))
                for i in range(12)]
        # no runtime declared and no estimate: -1
        jobs.append(_job(P, "unknown", mem=100, cpus=1, command="new.sh"))
        store.submit_jobs(jobs)
        for i in range(0, 12, 3):
            store.create_instance(f"j{i}", f"t{i}", hostname="h0")
            clock.advance(int(rng.integers(60_000, 4_000_000)))
            store.update_instance_state(
                f"t{i}", P.ent.InstanceStatus.FAILED,
                "node-removed" if i % 2 == 0 else "killed-by-user")
        predictor = P.pred.QuantileRuntimePredictor(min_samples=1)
        predictor.observe("u1", "c1", 120_000)
        predictor.observe("u0", "c2", 40_000)
        config = P.matcher.MatchConfig(completion_multiplier=1.5,
                                       host_lifetime_mins=90.0,
                                       agent_start_grace_mins=10.0)
        live = [store.jobs[j.uuid] for j in jobs]
        out[P.name] = P.matcher.estimated_end_times(
            store, live, config, predictor=predictor)
    np.testing.assert_array_equal(out["port"], out["ref"])
    assert (out["port"] > 0).any() and (out["port"] < 0).any()


def _est_rig(P, hosts, match):
    clock = FakeClock()
    store = P.store.JobStore(clock=clock)
    store.set_pool(P.ent.Pool(name="default"))
    cluster = P.mock.MockCluster("m", hosts, clock=clock)
    scheduler = P.core.Scheduler(store, [cluster], P.core.SchedulerConfig(
        match=match), **P.kw)
    return clock, store, cluster, scheduler


def _est_config(P):
    return P.matcher.MatchConfig(completion_multiplier=1.5,
                                 host_lifetime_mins=60,
                                 agent_start_grace_mins=10)


def _dated_host(P, name, started_min_ago):
    return P.mock.MockHost(
        node_id=name, hostname=name, mem=8000, cpus=32,
        attributes=(("host-start-time",
                     str(10_000_000 - started_min_ago * 60)),))


def test_estimated_completion_avoids_dying_hosts():
    """tests/test_constraints_extended.py:84: a job expected to run 30 min
    (x1.5 = 45 min) skips a host that dies in 20 min and takes one that
    dies in 50."""
    out = {}
    for P in (REF, PORT):
        clock, store, _cluster, scheduler = _est_rig(
            P, [_dated_host(P, "old", 40), _dated_host(P, "fresh", 10)],
            _est_config(P))
        clock.now_ms = 10_000_000_000  # epoch 1e7 s
        store.submit_jobs([_job(P, "j", mem=100, cpus=1,
                                expected_runtime_ms=30 * 60_000)])
        pool = store.pools["default"]
        scheduler.rank_cycle(pool)
        [(job, offer)] = scheduler.match_cycle(pool).matched
        assert offer.hostname == "fresh"
        out[P.name] = offer.hostname
    assert out["port"] == out["ref"]


@PKGS
def test_estimated_completion_ignores_hosts_without_start_time(P):
    """tests/test_constraints_extended.py:104."""
    clock, store, _cluster, scheduler = _est_rig(
        P, [P.mock.MockHost(node_id="h", hostname="h", mem=8000, cpus=32)],
        _est_config(P))
    store.submit_jobs([_job(P, "j", mem=100, cpus=1,
                            expected_runtime_ms=10**9)])
    pool = store.pools["default"]
    scheduler.rank_cycle(pool)
    assert scheduler.match_cycle(pool).matched


def test_estimated_completion_with_a_warm_predictor_closes_dying_hosts():
    """A job that declared no runtime but whose (user, command) the
    predictor knows runs 40 min (x1.5 = 60 min, capped at 50): only the
    host living another 55 min takes it; cold, it could go anywhere.  The
    predictor is the scheduler's own (speculation on)."""
    out = {}
    for P in (REF, PORT):
        for warm in (True, False):
            match = _est_config(P)
            clock = FakeClock()
            store = P.store.JobStore(clock=clock)
            store.set_pool(P.ent.Pool(name="default"))
            cluster = P.mock.MockCluster(
                "m", [_dated_host(P, "a-old", 30), _dated_host(P, "b-new", 5)],
                clock=clock)
            scheduler = P.core.Scheduler(
                store, [cluster], P.core.SchedulerConfig(
                    match=match, speculation=True,
                    predictor_min_samples=1), **P.kw)
            clock.now_ms = 10_000_000_000
            if warm:
                scheduler.predictor.observe("u0", "train.py", 40 * 60_000)
            store.submit_jobs([_job(P, "j", mem=100, cpus=1,
                                    command="train.py")])
            pool = store.pools["default"]
            scheduler.rank_cycle(pool)
            [(job, offer)] = scheduler.match_cycle(pool).matched
            out[(P.name, warm)] = offer.hostname
    assert out[("port", True)] == out[("ref", True)] == "b-new"
    assert out[("port", False)] == out[("ref", False)]


# -------------------------------------------------- speculation-hit H2D


@PKGS
def test_speculation_hit_reports_near_zero_h2d(P):
    """tests/test_data_plane.py:252: a cycle served from a committed
    speculation moved its tensors during the PREVIOUS cycle's drain — its
    own record shows zero H2D and only the small assignment fetch as
    D2H."""
    clock, store, cluster, scheduler = one_host_scenario(P)
    _, r1 = run_cycle(scheduler, store)
    assert r1.h2d_bytes > 0
    advance_wave(clock, cluster)
    run_cycle(scheduler, store)
    advance_wave(clock, cluster)
    _, r3 = run_cycle(scheduler, store)
    assert r3.speculation == "hit"
    assert r3.h2d_bytes == 0
    assert 0 < r3.d2h_bytes < 4096
    assert r3.data_plane.get(P.dp.FAM_SOLVE, {}).get("d2h_bytes", 0) > 0


# ------------------------------------------- chip_smoke.py's phases (CPU)


def test_chip_smoke_speculation_phases_on_cpu(tmp_path):
    """chip_smoke.py's speculation phases at a CPU test's size: the wave
    on the exact greedy (identical traces, hit fraction >= 0.2, a lower
    pre-launch p50, no H2D on a hit), the wave on the `pallas` and
    hierarchical knobs with the speculative solves' kernel calls kept,
    the flat slice speculating equal to its classic replay, the pipelined
    rig hitting on every warm pass, and the agreement replays equal on
    two devices (here the CPU twice)."""
    import chip_smoke
    from cook_tpu_torch.sim import cli
    from cook_tpu_torch.sim.simulator import load_trace
    from cook_tpu_torch.utils.config import default_match_config

    wave = dict(chip_smoke.SPEC_WAVE, jobs=240, hosts=40)
    stats = chip_smoke.speculation_wave_phase(device="cpu", wave=wave)
    assert stats["hit_fraction"] >= 0.5
    trace = str(tmp_path / "small.json")
    assert cli.main(["synth", "--jobs", "1500", "--hosts", "120",
                     "--users", "50", "--submit-span-ms", "60000",
                     "--out", trace]) == 0
    jobs, hosts = load_trace(trace)
    _, classic, _, _ = chip_smoke.spec_replay(
        jobs, hosts, default_match_config(max_jobs_considered=16_384,
                                          chunk=1024, backend="pallas"),
        3, False, device="cpu")
    _, kept = chip_smoke.speculation_kernels_phase(
        trace, classic.to_csv(), device="cpu", wave=wave)
    assert all(kept.values())
    chip_smoke.speculation_pipelined_phase(
        device="cpu", n_pools=3,
        pool_wave=dict(chip_smoke.SPEC_WAVE, jobs=60, hosts=10), cycles=4)
    chip_smoke.speculation_agreement_phase(devices=("cpu", "cpu"))
