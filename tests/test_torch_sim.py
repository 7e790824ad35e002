"""The slice as a whole: the port's simulator (rank -> chunked or
hierarchical match -> launch) replays a synthetic trace to the same run
trace as the reference simulator, on the CPU.

Each parity test runs both packages with the same `use_columnar_index`:
False (each package's `rank_pool`; the cases keep their earlier ids) and
True (each package's columnar rank, the default; ids end in `-defaults`,
and there the whole default `SchedulerConfig` runs on both sides: the
encode cache, the flight recorder and the device telemetry too).  The two
rank paths break equal-DRU ties in different (equally valid) orders, so
the two settings give different traces."""
import numpy as np
import pytest
import torch

from cook_tpu.scheduler.core import SchedulerConfig as RefSchedulerConfig
from cook_tpu.scheduler.matcher import MatchConfig as RefMatchConfig
from cook_tpu.sim import cli as ref_cli
from cook_tpu.sim import simulator as ref_sim
from cook_tpu_torch.scheduler.core import SchedulerConfig
from cook_tpu_torch.scheduler.matcher import MatchConfig
from cook_tpu_torch.sim import cli
from cook_tpu_torch.sim import simulator as sim

# one intra-op thread: the suite runs several pytest-xdist workers side
# by side, and idle OpenMP threads spinning in each would crowd them
torch.set_num_threads(1)

CONFIGS = {
    "exact": {},
    # tests/test_pallas_match.py:156's scheduler config
    "pallas": dict(chunk=16, backend="pallas", chunk_rounds=2,
                   chunk_passes=12),
    # the same, with every solve on the hierarchical path and both of its
    # backends on the kernels (the reference's mesh off: its tests run 8
    # virtual CPU devices, and one card has no mesh)
    "hier": dict(chunk=16, backend="pallas", chunk_rounds=2,
                 chunk_passes=12, hierarchical_threshold=1,
                 hierarchical_nodes_per_block=8,
                 hierarchical_coarse_backend="pallas",
                 hierarchical_fine_backend="pallas",
                 hierarchical_use_mesh=False),
}


def _rows(csv_text):
    import csv
    import io

    return list(csv.DictReader(io.StringIO(csv_text)))


def _columnar_params(names):
    """(name, use_columnar_index) cases: the earlier ids for False, and a
    `-defaults` id for the default True."""
    return [pytest.param(name, False, id=name) for name in names] + [
        pytest.param(name, True, id=f"{name}-defaults") for name in names]


@pytest.mark.parametrize("config,columnar", _columnar_params(sorted(CONFIGS)))
def test_port_simulator_reproduces_reference_trace(config, columnar):
    """With `columnar` both packages run their default SchedulerConfig
    (columnar rank, encode cache, flight recorder, device telemetry): the
    reference's default decisions, byte for byte."""
    jobs, hosts = ref_sim.synth_trace(200, 20, seed=3)
    want = ref_sim.Simulator(jobs, hosts, ref_sim.SimConfig(
        scheduler=RefSchedulerConfig(
            match=RefMatchConfig(**CONFIGS[config]),
            use_columnar_index=columnar))).run()
    pjobs, phosts = sim.synth_trace(200, 20, seed=3)
    got = sim.Simulator(pjobs, phosts, sim.SimConfig(
        scheduler=SchedulerConfig(match=MatchConfig(**CONFIGS[config]),
                                  use_columnar_index=columnar)),
        device="cpu").run()
    ok, diffs = cli.traces_equivalent(_rows(want.to_csv()),
                                      _rows(got.to_csv()))
    assert ok, diffs
    assert got.to_csv() == want.to_csv()  # byte-compatible run traces
    assert got.cycles == want.cycles
    assert sum(r["status"] == "success" for r in got.rows) == 200
    assert got.utilization(phosts) == pytest.approx(
        want.utilization(hosts), rel=0, abs=0)
    if columnar:
        assert got.health["status"] == want.health["status"] == "ok"
        assert len(got.cycle_records) == len(want.cycle_records)


# the chip smoke's slices' flat knobs (chunk 1024, the tuned rounds,
# passes and kc), on the smoke's small trace (3,000 jobs x 300 hosts)
TUNED_FLAT = dict(max_jobs_considered=16384, chunk=1024, backend="pallas")


def test_slices_flat_knobs_drift_in_the_reference_too():
    """Both packages at their default SchedulerConfig with the slices' flat
    knobs, a shadow solve and a health check every cycle: the run traces
    are byte-identical, and the final verdicts (status, reasons, the
    quality monitor's last efficiency and sample count) are equal.  At
    these knobs the verdict is `quality-drift` in the reference as in the
    port; the efficiency is computed by the same numpy formula from the
    same assignment and is compared exactly."""
    from cook_tpu.utils.config import default_match_config as ref_dmc
    from cook_tpu_torch.utils.config import default_match_config

    jobs, hosts = ref_sim.synth_trace(3000, 300, n_users=50, seed=0,
                                      submit_span_ms=60000)
    want = ref_sim.Simulator(jobs, hosts, ref_sim.SimConfig(
        max_cycles=6, health_every=1, scheduler=RefSchedulerConfig(
            match=ref_dmc(**TUNED_FLAT), quality_sample_every=1))).run()
    pjobs, phosts = sim.synth_trace(3000, 300, n_users=50, seed=0,
                                    submit_span_ms=60000)
    got = sim.Simulator(pjobs, phosts, sim.SimConfig(
        max_cycles=6, health_every=1, scheduler=SchedulerConfig(
            match=default_match_config(**TUNED_FLAT),
            quality_sample_every=1)), device="cpu").run()
    assert got.to_csv() == want.to_csv()
    for key in ("status", "reasons"):
        assert got.health[key] == want.health[key]
    assert want.health["reasons"] == ["quality-drift"]
    assert (got.health["checks"]["quality"]
            == want.health["checks"]["quality"])
    assert [c["reasons"] for c in got.health_checks][-1] == ["quality-drift"]


def test_trace_and_csv_formats_cross_packages(tmp_path):
    """A trace written by either CLI loads identically in both packages,
    and `compare` accepts run traces of either package."""
    port_trace = str(tmp_path / "port.json")
    ref_trace = str(tmp_path / "ref.json")
    args = ["--jobs", "60", "--hosts", "6", "--users", "4",
            "--submit-span-ms", "60000", "--seed", "1"]
    assert cli.main(["synth", *args, "--out", port_trace]) == 0
    assert ref_cli.main(["synth", *args, "--out", ref_trace]) == 0
    assert open(port_trace).read() == open(ref_trace).read()
    pj, ph = sim.load_trace(ref_trace)
    rj, rh = ref_sim.load_trace(port_trace)
    assert [vars(j) for j in pj] == [vars(j) for j in rj]
    assert [vars(h) for h in ph] == [vars(h) for h in rh]

    port_csv = str(tmp_path / "port.csv")
    ref_csv = str(tmp_path / "ref.csv")
    assert cli.main(["run", "--trace", port_trace, "--out", port_csv,
                     "--device", "cpu", "--chunk", "0"]) == 0
    # the port's CLI runs the default SchedulerConfig: so does the
    # reference here
    ref_result = ref_sim.Simulator(rj, rh, ref_sim.SimConfig(
        scheduler=RefSchedulerConfig())).run()
    with open(ref_csv, "w") as f:
        f.write(ref_result.to_csv())
    assert cli.main(["compare", port_csv, ref_csv]) == 0
    assert ref_cli.main(["compare", ref_csv, port_csv]) == 0


def test_replay_hands_the_simulator_to_on_sim_before_it_runs(tmp_path):
    """`cli.replay(args, on_sim=...)` calls the hook once, with the
    Simulator it then runs (no cycle run yet), and writes the same CSV as
    a replay without the hook."""
    trace = str(tmp_path / "t.json")
    assert cli.main(["synth", "--jobs", "40", "--hosts", "4", "--users",
                     "3", "--seed", "2", "--out", trace]) == 0
    runs = {}
    for hooked in (False, True):
        out = str(tmp_path / f"{hooked}.csv")
        args = cli.build_parser().parse_args(
            ["run", "--trace", trace, "--out", out, "--device", "cpu"])
        seen = []
        simulator, _, result = cli.replay(
            args, on_sim=(lambda s: seen.append((s, s.now_ms)))
            if hooked else None)
        assert seen == ([(simulator, 0)] if hooked else [])
        runs[hooked] = open(out, newline="").read()
        assert runs[hooked] == result.to_csv()
    assert runs[True] == runs[False]


def test_default_match_config_reads_tuned_defaults(monkeypatch, tmp_path):
    from cook_tpu.utils.config import default_match_config as ref_default
    from cook_tpu_torch.utils.config import default_match_config

    for tuned in (None, "off"):
        if tuned is None:
            monkeypatch.delenv("COOK_TUNED_MATCH", raising=False)
        else:
            monkeypatch.setenv("COOK_TUNED_MATCH", tuned)
        got = default_match_config(max_jobs_considered=77, backend="pallas")
        want = ref_default(max_jobs_considered=77, backend="pallas")
        for name in ("max_jobs_considered", "chunk", "chunk_rounds",
                     "chunk_passes", "chunk_kc", "backend"):
            assert getattr(got, name) == getattr(want, name), name


HIER_KEYS = ("hierarchical_threshold", "hierarchical_nodes_per_block",
             "hierarchical_jobs_per_block", "hierarchical_refine_rounds",
             "hierarchical_superblock_nodes", "hierarchical_coarse_backend",
             "hierarchical_use_mesh", "hierarchical_fine_backend")


@pytest.mark.parametrize("overrides", [
    {},
    dict(hierarchical_threshold=1, hierarchical_nodes_per_block=64,
         hierarchical_jobs_per_block=256, hierarchical_refine_rounds=0,
         hierarchical_coarse_backend="pallas",
         hierarchical_fine_backend="pallas", hierarchical_use_mesh=False),
    # the superblock key and its long-form alias
    dict(hier_superblock_nodes=4096),
    dict(hierarchical_superblock_nodes=2048),
], ids=["defaults", "all", "superblock-key", "superblock-alias"])
def test_default_match_config_reads_hierarchical_keys(overrides):
    from cook_tpu.utils.config import default_match_config as ref_default
    from cook_tpu_torch.utils.config import default_match_config

    got = default_match_config(**overrides)
    want = ref_default(**overrides)
    for name in HIER_KEYS:
        assert getattr(got, name) == getattr(want, name), name


def test_unsubmitted_jobs_report_unscheduled():
    """A run cut by max_cycles before the trace's last submit: the
    reference raises KeyError in _collect_rows (sim/simulator.py:597);
    the port reports those jobs as unscheduled."""
    jobs, hosts = sim.synth_trace(40, 4, submit_span_ms=300_000)
    result = sim.Simulator(jobs, hosts, sim.SimConfig(max_cycles=2),
                           device="cpu").run()
    statuses = {r["status"] for r in result.rows}
    assert "unscheduled" in statuses
    assert len({r["job_uuid"] for r in result.rows}) == 40


def test_profile_reports_phase_walls_on_cpu(tmp_path, capsys):
    import json

    from cook_tpu_torch.sim import profile

    trace = str(tmp_path / "t.json")
    cli.main(["synth", "--jobs", "40", "--hosts", "4", "--users", "5",
              "--submit-span-ms", "60000", "--out", trace])
    capsys.readouterr()
    assert profile.main(["--trace", trace, "--out", str(tmp_path / "r.csv"),
                         "--device", "cpu", "--chunk", "0",
                         "--max-cycles", "3"]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["device"] == "cpu" and report["device_ms"] is None
    assert set(report["phase_wall_ms"]) == {"submit", "rank", "encode",
                                            "solve", "launch"}
    assert len(report["cycle_wall_ms"]) == report["summary"]["cycles"] == 3
    # match's encode / solve / launch split lies inside its wall (each
    # rounded to the millisecond in the summary)
    walls = report["summary"]["phase_wall_s"]
    split = walls["encode"] + walls["solve"] + walls["launch"]
    assert 0 < split <= walls["match"] + 0.003


def test_small_slice_places_within_capacity():
    """The smoke's configuration (chunk 1024, best_node backend, tuned
    rounds/passes) at a CPU-sized trace: jobs land and no host is
    oversubscribed."""
    from chip_smoke import check_capacity

    jobs, hosts = sim.synth_trace(3000, 50, n_users=50,
                                  submit_span_ms=60_000)
    args = cli.build_parser().parse_args(
        ["run", "--trace", "unused", "--device", "cpu",
         "--considerable", "16384", "--chunk", "1024", "--backend",
         "pallas", "--max-cycles", "3"])
    s = sim.Simulator(jobs, hosts, cli.sim_config(args), device="cpu")
    result = s.run()
    assert s.config.scheduler.match.chunk_passes >= 1
    assert sum(r["start_ms"] is not None for r in result.rows) > 0
    assert check_capacity(s) > 0
    assert np.isfinite(result.utilization(hosts))


def test_small_hier_slice_places_within_capacity():
    """chip_smoke.py's hierarchical configuration at a CPU-sized trace:
    every solve takes the two-level path, jobs land, its phase walls are
    summed beside the others, and no host is oversubscribed."""
    from chip_smoke import HIER_MATCH, check_capacity
    from cook_tpu_torch.utils.config import default_match_config

    jobs, hosts = sim.synth_trace(3000, 50, n_users=50,
                                  submit_span_ms=60_000)
    s = sim.Simulator(jobs, hosts, sim.SimConfig(
        max_cycles=3, scheduler=SchedulerConfig(
            match=default_match_config(**HIER_MATCH,
                                       hierarchical_nodes_per_block=8))),
        device="cpu")
    result = s.run()
    assert sum(r["start_ms"] is not None for r in result.rows) > 0
    assert check_capacity(s) > 0
    walls = result.phase_wall_s
    split = walls["coarse_solve"] + walls["fine_solve"] + walls["refine"]
    assert 0 < split <= walls["solve"]


# ------------------------------------------------------------- rebalance
# rank -> match -> rebalance every cycle: the run trace, the fairness
# ledger and the host reservations after every match and every rebalance
# must equal the reference simulator's


def _with_share(s, ent, mem, cpus, dynamic=None):
    s.store.set_share(ent.Share(user=ent.DEFAULT_USER, pool="default",
                                resources=ent.Resources(mem=mem, cpus=cpus)))
    if dynamic is not None:
        s.store.dynamic_config["rebalancer"] = dynamic
    return s


def _preemption_heavy(mod):
    """tests/test_fairness.py:378's run: the reference's share and
    dynamic rebalancer overrides."""
    from cook_tpu.sim import loadgen as ref_loadgen
    from cook_tpu_torch.sim import loadgen

    gen = ref_loadgen if mod is ref_sim else loadgen
    jobs, hosts = gen.preemption_heavy_trace(
        hog_jobs=8, late_jobs=3, hosts=4, runtime_ms=240_000,
        late_arrival_ms=30_000, n_late_users=3)
    return jobs, hosts, 60, (500.0, 2.0), {
        "safe_dru_threshold": 0.0, "min_dru_diff": 0.01,
        "max_preemption": 10}, {}


def _whole_host(mod):
    """chip_smoke.whole_host_trace at 8 hosts: two-victim decisions that
    reserve their host; the default RebalancerParams and a share of 1/500
    of the fleet, as chip_smoke.py replays it."""
    from chip_smoke import whole_host_trace

    jobs, hosts = whole_host_trace(mod.TraceJob, mod.TraceHost, hosts=8)
    return jobs, hosts, 8, (8 * 65_536 / 500, 8 * 32 / 500), None, {}


def _preemption_heavy_200(mod):
    """chip_smoke.py's rebalance slice at 200 hosts: the hog fills the
    fleet, nine late users arrive at 60 s (cycle 3), and cycles 3 and 4
    take the default max_preemption of 100 decisions each, so later
    searches read the cycle's fixed-row state after tens of in-place
    updates.  Share 1/500 of the fleet, default RebalancerParams.  Four
    cycles, not the slice's six: the reference compiles a scatter for
    each decision it applies (about 0.5 s each on a CPU)."""
    from chip_smoke import REB_TRACE
    from cook_tpu.sim import loadgen as ref_loadgen
    from cook_tpu_torch.sim import loadgen

    gen = ref_loadgen if mod is ref_sim else loadgen
    jobs, hosts = gen.preemption_heavy_trace(**dict(
        REB_TRACE, hosts=200, hog_jobs=400, late_jobs=1600,
        n_late_users=9))
    return jobs, hosts, 4, (200 * 65_536 / 500, 200 * 32 / 500), None, \
        {"max_jobs_considered": 16384}


REBALANCE_TRACES = {"preemption-heavy": _preemption_heavy,
                    "preemption-heavy-200": _preemption_heavy_200,
                    "whole-host": _whole_host}


def _rebalance_run(mod, trace, columnar):
    from chip_smoke import RebalanceLog
    from cook_tpu.models import entities as ref_ent
    from cook_tpu_torch.models import entities as port_ent

    jobs, hosts, cycles, share, dynamic, match = \
        REBALANCE_TRACES[trace](mod)
    if mod is ref_sim:
        s = ref_sim.Simulator(jobs, hosts, ref_sim.SimConfig(
            rebalance_every=1, max_cycles=cycles,
            scheduler=RefSchedulerConfig(use_columnar_index=columnar,
                                         match=RefMatchConfig(**match))))
        ent = ref_ent
    else:
        s = sim.Simulator(jobs, hosts, sim.SimConfig(
            rebalance_every=1, max_cycles=cycles,
            scheduler=SchedulerConfig(use_columnar_index=columnar,
                                      match=MatchConfig(**match))),
            device="cpu")
        ent = port_ent
    _with_share(s, ent, *share, dynamic)
    log = RebalanceLog(s)
    return s.run(), log


@pytest.mark.parametrize("trace,columnar",
                         _columnar_params(sorted(REBALANCE_TRACES)))
def test_port_simulator_reproduces_reference_rebalance(trace, columnar):
    from chip_smoke import ledger_view

    want, want_log = _rebalance_run(ref_sim, trace, columnar)
    got, got_log = _rebalance_run(sim, trace, columnar)
    assert got.to_csv() == want.to_csv()  # byte-identical run traces
    assert got.cycles == want.cycles
    assert ledger_view(got) == ledger_view(want)
    assert got.fairness["pools"]["default"]["rollups"] == \
        want.fairness["pools"]["default"]["rollups"]
    assert got_log.reservations == want_log.reservations
    def counts(log):  # each cycle's decisions, victims, reservations
        return [{k: v for k, v in c.items() if k != "wall_s"}
                for c in log.cycles]

    assert counts(got_log) == counts(want_log)
    victims = sum(c["victims"] for c in got_log.cycles)
    assert victims == got.fairness["pools"]["default"]["rollups"][
        "tasks_preempted"] > 0
    assert "rebalance" in got.phase_wall_s
    if columnar:
        # the cycle records carry the preemptions, as the reference's
        assert [[p["task_ids"] for p in r["preemptions"]]
                for r in got.cycle_records] == [
            [p["task_ids"] for p in r["preemptions"]]
            for r in want.cycle_records]
    if trace == "whole-host":
        made = sum(c["reserved"] for c in got_log.cycles)
        assert made == 4                    # one per whole-host job
        assert got_log.placed_on_reserved == made
    if trace == "preemption-heavy-200":
        # cycles that reach the default max_preemption of 100 decisions
        assert [c["decisions"] for c in got_log.cycles] == [0, 0, 100, 100]


def test_preemption_heavy_trace_ab_vs_standard():
    """tests/test_fairness.py:353 through the port: the preemption-heavy
    trace shows preemptions, wasted work and a depressed Jain index; the
    standard completion-heavy run none of them."""
    from cook_tpu_torch.models import entities as port_ent
    from cook_tpu_torch.sim.loadgen import (completion_heavy_trace,
                                            preemption_heavy_trace)

    def _run(jobs, hosts):
        s = sim.Simulator(jobs, hosts, sim.SimConfig(
            cycle_ms=30_000, rebalance_every=1, max_cycles=60),
            device="cpu")
        _with_share(s, port_ent, 500.0, 2.0, {
            "safe_dru_threshold": 0.0, "min_dru_diff": 0.01,
            "max_preemption": 10})
        result = s.run()
        return result, list(
            s.scheduler.fairness._baselines["default"]._samples)

    heavy, heavy_jain = _run(*preemption_heavy_trace(
        hog_jobs=8, late_jobs=3, hosts=4, runtime_ms=240_000,
        late_arrival_ms=30_000, n_late_users=3))
    std, std_jain = _run(*completion_heavy_trace(
        jobs=8, hosts=4, runtime_ms=60_000, n_users=1))
    heavy_body = heavy.fairness["pools"]["default"]
    std_body = std.fairness["pools"]["default"]
    assert heavy_body["rollups"]["tasks_preempted"] >= 1
    assert heavy_body["rollups"]["wasted_s"]["fairness"] > 0.0
    assert heavy_body["ledger"]
    assert std_body["rollups"]["tasks_preempted"] == 0
    assert std_body["rollups"]["wasted_s"]["fairness"] == 0.0
    assert min(heavy_jain) < 0.97
    assert min(std_jain) > 0.999


@pytest.mark.parametrize("name,kwargs", [
    ("completion_heavy_trace", {}),
    ("completion_heavy_trace", dict(jobs=9, hosts=3, n_users=4, seed=5)),
    ("preemption_heavy_trace", {}),
    ("preemption_heavy_trace", dict(hog_jobs=20, late_jobs=30, hosts=10,
                                    host_mem=65_536, host_cpus=32,
                                    n_late_users=7, seed=3)),
])
def test_loadgen_traces_equal_reference(name, kwargs):
    from cook_tpu.sim import loadgen as ref_loadgen
    from cook_tpu_torch.sim import loadgen

    got_jobs, got_hosts = getattr(loadgen, name)(**kwargs)
    want_jobs, want_hosts = getattr(ref_loadgen, name)(**kwargs)
    assert [vars(j) for j in got_jobs] == [vars(j) for j in want_jobs]
    assert [vars(h) for h in got_hosts] == [vars(h) for h in want_hosts]


def test_cli_rebalance_flags_reach_the_config(tmp_path, capsys):
    import json

    args = cli.build_parser().parse_args(
        ["run", "--trace", "t.json", "--rebalance-every", "2",
         "--safe-dru-threshold", "0.25", "--min-dru-diff", "0.125",
         "--max-preemption", "7"])
    cfg = cli.sim_config(args)
    assert cfg.rebalance_every == 2
    params = cfg.scheduler.rebalancer
    assert (params.safe_dru_threshold, params.min_dru_diff,
            params.max_preemption) == (0.25, 0.125, 7)
    # and a CPU replay with the rebalancer on reports its phase wall
    trace = str(tmp_path / "t.json")
    cli.main(["synth", "--jobs", "30", "--hosts", "3", "--users", "3",
              "--submit-span-ms", "30000", "--out", trace])
    capsys.readouterr()
    assert cli.main(["run", "--trace", trace, "--out",
                     str(tmp_path / "r.csv"), "--device", "cpu", "--chunk",
                     "0", "--max-cycles", "3", "--rebalance-every", "1"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "rebalance" in summary["phase_wall_s"]


def test_small_rebalance_slice_on_cpu():
    """chip_smoke.py's rebalance slice at a CPU-sized trace (the
    preemption-heavy-200 parity case holds its decisions to the JAX
    simulator): the hog fills 200 hosts, the late users preempt it, each
    cycle's first, last and most-victims searches rerun identically,
    capacity holds throughout."""
    from chip_smoke import REB_TRACE, rebalance_slice_phase

    summary = rebalance_slice_phase(
        dict(REB_TRACE, hosts=200, hog_jobs=400, late_jobs=1600,
             n_late_users=9), device="cpu", cycles=6)
    assert sum(summary["victims"]) == summary["tasks_preempted"] > 0
    assert summary["padded_shape"] == (512, 256)
    assert summary["placements"]["late"] > 0
    # a cycle of many searches reruns at least its first and its last
    assert max(summary["searches"]) >= 2
    assert summary["searches_checked"] >= sum(
        min(n, 2) for n in summary["searches"])


# ------------------------------------------------------------------ gangs
# gang_topology_trace (8 hosts in blocks of 4, 60 cycles) with the gang
# machinery on (one-block rule, distance term) and off: the run trace and
# gang_stats must equal the reference simulator's; then the A/B of
# tests/test_gang_sim.py:48-113 on the port's runs

GANG_BLOCK_HOSTS = 4


def _gang_run(mod, match_mod, core_mod, *, gang_enabled, columnar=False,
              **sim_kw):
    from cook_tpu.sim import loadgen as ref_loadgen
    from cook_tpu_torch.sim import loadgen

    port = mod is sim
    jobs, hosts = (loadgen if port else ref_loadgen).gang_topology_trace(
        block_hosts=GANG_BLOCK_HOSTS)
    match = match_mod.MatchConfig(
        gang_enabled=gang_enabled, topology_block_hosts=GANG_BLOCK_HOSTS,
        topology_weight=0.5 if gang_enabled else 0.0)
    cfg = mod.SimConfig(cycle_ms=30_000, max_cycles=60,
                        scheduler=core_mod.SchedulerConfig(
                            match=match, use_columnar_index=columnar))
    s = mod.Simulator(jobs, hosts, cfg, **sim_kw)
    result = s.run()
    return jobs, hosts, result, result.gang_stats(
        jobs, hosts, nodes_per_block=GANG_BLOCK_HOSTS)


@pytest.fixture(scope="module")
def gang_ab():
    from cook_tpu.scheduler import core as ref_core
    from cook_tpu.scheduler import matcher as ref_matcher
    from cook_tpu_torch.scheduler import core as port_core
    from cook_tpu_torch.scheduler import matcher as port_matcher

    runs = {}
    for mode in ("naive", "gang", "naive-defaults", "gang-defaults"):
        on = mode.startswith("gang")
        columnar = mode.endswith("-defaults")
        runs[mode] = _gang_run(sim, port_matcher, port_core,
                               gang_enabled=on, columnar=columnar,
                               device="cpu")
        runs["ref " + mode] = _gang_run(ref_sim, ref_matcher, ref_core,
                                        gang_enabled=on, columnar=columnar)
    return runs


@pytest.mark.parametrize("mode", ["naive", "gang", "naive-defaults",
                                  "gang-defaults"])
def test_port_simulator_reproduces_reference_gang_trace(gang_ab, mode):
    _, _, got, got_stats = gang_ab[mode]
    _, _, want, want_stats = gang_ab["ref " + mode]
    assert got.to_csv() == want.to_csv()
    assert got.cycles == want.cycles and got.virtual_ms == want.virtual_ms
    assert got_stats == want_stats


def test_every_gang_completes_both_modes(gang_ab):
    for mode in ("naive", "gang"):
        for g in gang_ab[mode][3]["per_gang"]:
            assert g["placed_members"] == g["size"], (mode, g)


def test_gang_mode_assembles_more_gangs_and_waits_less(gang_ab):
    gang, naive = gang_ab["gang"][3], gang_ab["naive"][3]
    assert gang["assembled"] == gang["gangs"] > naive["assembled"]
    assert gang["wait_ms_p50"] < naive["wait_ms_p50"]
    # the one-block rule: every assembled gang is contiguous
    assert gang["mean_block_spread"] == 1.0 < naive["mean_block_spread"]


def _first_starts(jobs, result):
    """gang -> the start times of its members' first runs."""
    first = {}
    for r in result.rows:
        if r["start_ms"] is not None:
            first[r["job_uuid"]] = min(first.get(r["job_uuid"], r["start_ms"]),
                                       r["start_ms"])
    starts = {}
    for tj in jobs:
        if tj.gang:
            starts.setdefault(tj.gang, []).append(first.get(tj.uuid))
    return starts


def test_gang_mode_never_partially_places(gang_ab):
    """Cycle-granular all-or-nothing, read off the run trace (the port has
    no cycle records yet): every member of a gang first starts in the same
    cycle; with the gang machinery off, some gang trickles."""
    for mode, whole in (("gang", True), ("naive", False)):
        jobs, _, result, _ = gang_ab[mode]
        starts = _first_starts(jobs, result)
        assert all(None not in v for v in starts.values())
        assert all(len(set(v)) == 1 for v in starts.values()) == whole, mode


def test_scalar_churn_not_starved_by_gang_mode(gang_ab):
    """The scalar top-up: stripped gangs hand hosts back, so gang mode
    does not stretch the run for the non-gang workload."""
    assert gang_ab["gang"][2].virtual_ms <= gang_ab["naive"][2].virtual_ms


def test_gang_traces_submit_each_gang_atomically():
    """The simulator aligns a gang's members to its latest submit time and
    submits them in one batch under a UNIQUE group; a one-member tag stays
    scalar."""
    jobs, hosts = sim.synth_trace(6, 2, submit_span_ms=60_000)
    jobs[0].gang = jobs[1].gang = jobs[2].gang = "g1"
    jobs[3].gang = "solo"
    s = sim.Simulator(jobs, hosts, sim.SimConfig(max_cycles=4),
                      device="cpu")
    due = {j.uuid: j.submit_time_ms for j in s.trace_jobs}
    assert len({due[j.uuid] for j in jobs[:3]}) == 1
    assert due[jobs[0].uuid] == max(j.submit_time_ms for j in jobs[:3])
    s.run()
    group = s.store.groups["g1"]
    assert sorted(group.job_uuids) == sorted(j.uuid for j in jobs[:3])
    assert group.host_placement.type.value == "unique"
    assert {s.store.jobs[j.uuid].gang_size for j in jobs[:3]} == {3}
    assert s.store.jobs[jobs[3].uuid].gang_size == 0
    assert "solo" not in s.store.groups


def test_small_gang_mix_matches_reference():
    _small_gang_mix(columnar=False)


def test_small_gang_mix_matches_reference_at_defaults():
    _small_gang_mix(columnar=True)


def _small_gang_mix(columnar):
    """chip_smoke.py's gang mix (every tenth job a member of a gang of 2,
    4, 8 or 16) on its flat gang route (chunk 1024 on the best_node
    backend, blocks of 32 hosts bound) at 2,000 jobs x 200 hosts, 3
    cycles: the run trace and each gang's placed members and block spread
    equal the reference simulator's; no gang partly placed, each on
    distinct hosts of one block.  (Most members still run when these runs
    end: the reference's gang_stats counts such a gang as never assembled,
    the port's as assembled from its start.)"""
    from chip_smoke import GANG_FLAT_MATCH, gang_mix
    from cook_tpu.scheduler.core import SchedulerConfig as RefSched
    from cook_tpu.utils.config import default_match_config as ref_default
    from cook_tpu_torch.utils.config import default_match_config

    knobs = dict(GANG_FLAT_MATCH, topology_block_hosts=32)
    runs = {}
    extra = dict(use_columnar_index=columnar)
    for label, mod, match in (
            ("port", sim, default_match_config(**knobs)),
            ("ref", ref_sim, ref_default(**knobs))):
        jobs, hosts = mod.synth_trace(2000, 200, n_users=50,
                                      submit_span_ms=60_000)
        jobs = gang_mix(jobs)
        sched = (SchedulerConfig if label == "port" else RefSched)(
            match=match, **extra)
        s = mod.Simulator(jobs, hosts, mod.SimConfig(
            cycle_ms=30_000, max_cycles=3, scheduler=sched),
            **({"device": "cpu"} if label == "port" else {}))
        result = s.run()
        runs[label] = (jobs, hosts, result, result.gang_stats(
            jobs, hosts, nodes_per_block=32))
    jobs, hosts, got, got_stats = runs["port"]
    _, _, want, want_stats = runs["ref"]
    assert got.to_csv() == want.to_csv()
    per_gang = got_stats["per_gang"]
    assert [(g["gang"], g["placed_members"], g["block_spread"])
            for g in per_gang] == [
        (g["gang"], g["placed_members"], g["block_spread"])
        for g in want_stats["per_gang"]]
    assert want_stats["assembled"] == 0
    assert got_stats["assembled"] == sum(g["placed_members"] == g["size"]
                                         for g in per_gang)
    assert sum(g["placed_members"] == g["size"] for g in per_gang) > 0
    assert all(g["placed_members"] in (0, g["size"]) for g in per_gang)
    assert all(g["block_spread"] <= 1 for g in per_gang)
    host_of = {r["job_uuid"]: r["host"] for r in got.rows
               if r["start_ms"] is not None}
    members = {}
    for tj in jobs:
        if tj.gang and tj.uuid in host_of:
            members.setdefault(tj.gang, []).append(host_of[tj.uuid])
    assert all(len(set(h)) == len(h) for h in members.values())


def test_default_match_config_reads_gang_keys():
    from cook_tpu.utils.config import default_match_config as ref_default
    from cook_tpu_torch.utils.config import default_match_config

    for overrides in ({}, dict(gang_enabled=False, topology_weight=0.25,
                               topology_block_hosts=96)):
        got = default_match_config(**overrides)
        want = ref_default(**overrides)
        for name in ("gang_enabled", "topology_weight",
                     "topology_block_hosts"):
            assert getattr(got, name) == getattr(want, name), name
