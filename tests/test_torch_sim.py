"""The slice as a whole: the port's simulator (rank -> chunked or
hierarchical match -> launch) replays a synthetic trace to the same run
trace as the reference simulator, on the CPU.

The reference scheduler is run with `use_columnar_index=False`: the port
ranks with the reference's `rank_pool` (its non-columnar branch); the
columnar fast path is a later slice and breaks equal-DRU ties in another
(equally valid) order."""
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


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_port_simulator_reproduces_reference_trace(config):
    jobs, hosts = ref_sim.synth_trace(200, 20, seed=3)
    want = ref_sim.Simulator(jobs, hosts, ref_sim.SimConfig(
        scheduler=RefSchedulerConfig(
            match=RefMatchConfig(**CONFIGS[config]),
            use_columnar_index=False))).run()
    pjobs, phosts = sim.synth_trace(200, 20, seed=3)
    got = sim.Simulator(pjobs, phosts, sim.SimConfig(
        scheduler=SchedulerConfig(match=MatchConfig(**CONFIGS[config]))),
        device="cpu").run()
    ok, diffs = cli.traces_equivalent(_rows(want.to_csv()),
                                      _rows(got.to_csv()))
    assert ok, diffs
    assert got.to_csv() == want.to_csv()  # byte-compatible run traces
    assert got.cycles == want.cycles
    assert sum(r["status"] == "success" for r in got.rows) == 200
    assert got.utilization(phosts) == pytest.approx(
        want.utilization(hosts), rel=0, abs=0)


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
    ref_result = ref_sim.Simulator(rj, rh, ref_sim.SimConfig(
        scheduler=RefSchedulerConfig(use_columnar_index=False))).run()
    with open(ref_csv, "w") as f:
        f.write(ref_result.to_csv())
    assert cli.main(["compare", port_csv, ref_csv]) == 0
    assert ref_cli.main(["compare", ref_csv, port_csv]) == 0


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


def test_gang_traces_are_refused():
    jobs, hosts = sim.synth_trace(4, 2)
    jobs[0].gang = jobs[1].gang = "g1"
    with pytest.raises(ValueError, match="gang"):
        sim.Simulator(jobs, hosts, device="cpu")


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
    assert set(report["phase_wall_ms"]) == {"rank", "encode", "solve",
                                            "launch"}
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
