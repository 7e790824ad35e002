"""The flight recorder of `cook_tpu_torch` against `cook_tpu` on the CPU.

A Simulator run of each package at its default `SchedulerConfig` (the
columnar rank, the encode cache, the flight recorder and the device
telemetry on) dumps one cycle record per match cycle.  The records must
be equal in every decision field — counts, skips with their reason codes
and details, matches with hosts and task ids, the solve's padded shape,
backend and first-seen flag, the hierarchical and gang accounting, the
pool capacity at cycle start, the data-plane bytes, rebuild fraction and
padding waste — on the flat (exact and `pallas`), hierarchical and gang
configurations.  Wall-clock fields are compared only for presence (their
keys), never for value: no test here reads the clock."""
import pytest
import torch

from cook_tpu.scheduler import core as ref_core
from cook_tpu.scheduler import matcher as ref_matcher
from cook_tpu.sim import loadgen as ref_loadgen
from cook_tpu.sim import simulator as ref_sim
from cook_tpu_torch.scheduler import core as port_core
from cook_tpu_torch.scheduler import flight_recorder as port_flight
from cook_tpu_torch.scheduler import matcher as port_matcher
from cook_tpu_torch.sim import loadgen as port_loadgen
from cook_tpu_torch.sim import simulator as port_sim

# one intra-op thread: the suite runs several pytest-xdist workers side
# by side, and idle OpenMP threads spinning in each would crowd them
torch.set_num_threads(1)

# wall-clock fields: values vary run to run
WALLS = ("wall_time", "device_s", "host_s", "total_s")
# dicts of walls: their keys are decisions (which phases ran), their
# values are not
WALL_DICTS = ("phases", "hier_phases")

FLAT = dict(chunk=16, backend="pallas", chunk_rounds=2, chunk_passes=12)
CONFIGS = {
    "exact": {},
    "pallas": FLAT,
    "hier": dict(FLAT, hierarchical_threshold=1,
                 hierarchical_nodes_per_block=8,
                 hierarchical_coarse_backend="pallas",
                 hierarchical_fine_backend="pallas"),
    "gang": dict(gang_enabled=True, topology_block_hosts=4,
                 topology_weight=0.5),
}


def _run(sim, core, matcher, loadgen, config, **kw):
    match = dict(CONFIGS[config])
    if sim is ref_sim and config == "hier":
        # the reference's tests run 8 virtual CPU devices; one card has
        # no mesh
        match["hierarchical_use_mesh"] = False
    if config == "gang":
        jobs, hosts = loadgen.gang_topology_trace(block_hosts=4)
        cycles = 60
    else:
        jobs, hosts = sim.synth_trace(200, 20, seed=3)
        cycles = 10_000
    result = sim.Simulator(jobs, hosts, sim.SimConfig(
        max_cycles=cycles,
        scheduler=core.SchedulerConfig(match=matcher.MatchConfig(**match))),
        **kw).run()
    return result


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def runs(request):
    want = _run(ref_sim, ref_core, ref_matcher, ref_loadgen, request.param)
    got = _run(port_sim, port_core, port_matcher, port_loadgen,
               request.param, device="cpu")
    return request.param, got, want


def _decisions(record):
    out = {k: v for k, v in record.items()
           if k not in WALLS and k not in WALL_DICTS}
    for k in WALL_DICTS:
        out[k] = sorted(record[k])
    return out


def test_cycle_records_equal_reference_in_every_decision_field(runs):
    config, got, want = runs
    assert got.to_csv() == want.to_csv()
    assert len(got.cycle_records) == len(want.cycle_records) == got.cycles
    for g, w in zip(got.cycle_records, want.cycle_records):
        assert set(g) == set(w)
        assert _decisions(g) == _decisions(w), g["cycle"]
        for key in WALLS:
            assert isinstance(g[key], float) and g[key] >= 0.0, key
    solved = [r for r in got.cycle_records if r["solve_shape"]]
    assert solved, "no cycle solved"
    if config == "hier":
        assert all(r["hierarchical"] for r in solved)
        assert {r["backend"] for r in solved} == {"hier-pallas-fine"}
        assert all(set(r["hier_phases"]) == {"coarse_solve", "fine_solve",
                                             "refine"} for r in solved)
    if config == "gang":
        assert sum(r["gangs_placed"] for r in got.cycle_records) > 0
    # every solved cycle's record has the four phases of a match cycle
    assert all(set(r["phases"]) >= {"tensor_build", "solve", "launch"}
               for r in solved)


def test_health_and_data_plane_equal_reference(runs):
    config, got, want = runs
    assert got.health["status"] == want.health["status"] == "ok"
    assert got.health["reasons"] == want.health["reasons"] == []
    assert got.health["checks"]["compile"] == \
        want.health["checks"]["compile"]
    assert got.health["checks"]["device_memory"] == {"observable": False}
    for key in ("mean_rebuild_fraction", "mean_padding_waste"):
        assert got.data_plane[key] == want.data_plane[key], key


def test_reason_codes_and_texts_equal_reference():
    from cook_tpu.scheduler import flight_recorder as ref_flight

    assert port_flight.REASON_TEXT == ref_flight.REASON_TEXT
    for name in ("MATCHED", "NO_OFFERS", "CONSTRAINTS_FILTERED",
                 "INSUFFICIENT_RESOURCES", "LAUNCH_CAP", "PORTS_EXHAUSTED",
                 "LAUNCH_VETOED", "LAUNCH_FAILED", "SOLVE_FAILED",
                 "NOT_CONSIDERED", "EXCEEDS_POOL_CAPACITY",
                 "CLUSTER_CIRCUIT_OPEN", "GANG_INCOMPLETE"):
        assert getattr(port_flight, name) == getattr(ref_flight, name)


def test_null_cycle_takes_every_call_the_matcher_makes():
    """The matcher writes through `flight` unconditionally; without a
    recorder it is NULL_CYCLE, whose calls do nothing."""
    null = port_flight.NULL_CYCLE
    assert null.record is None and null.dp is None
    with null.phase("solve", device=True):
        pass
    null.add_phase("rank", 1.0)
    null.set_counts(offers=1, queue_len=2, considered=3)
    null.note_solve("64x64", "exact", True)
    null.note_match("j", "h", "t")
    null.note_skip("j", port_flight.NO_OFFERS, "detail")
    null.note_not_considered("j")
    null.set_rank_context([], {})
    null.note_hierarchical({})
    null.note_gang(considered=1, placed=0, blocked=1, reasons={})


def test_recorder_off_writes_no_record():
    jobs, hosts = port_sim.synth_trace(40, 4, submit_span_ms=60_000)
    result = port_sim.Simulator(jobs, hosts, port_sim.SimConfig(
        max_cycles=3, scheduler=port_core.SchedulerConfig(
            flight_recorder_capacity=0, device_telemetry=False)),
        device="cpu").run()
    assert result.cycle_records == [] and result.health == {}
    assert result.cycles == 3


def test_committed_cycles_fold_into_the_ledger():
    """Each committed record's data-plane scope lands in the process
    ledger's cycle ring and per-pool residency, as the reference's does;
    `snapshot(cycles=0)` carries no cycle section."""
    from cook_tpu_torch.obs import data_plane

    jobs, hosts = port_sim.synth_trace(40, 4, submit_span_ms=60_000)
    result = port_sim.Simulator(jobs, hosts, port_sim.SimConfig(
        max_cycles=4), device="cpu").run()
    snap = data_plane.LEDGER.snapshot(cycles=4)
    encoded = [r for r in result.cycle_records
               if r["rebuild_fraction"] is not None]
    assert encoded and snap["cycles"]
    last = snap["cycles"][-1]
    assert last["cycle"] == encoded[-1]["cycle"]
    assert last["rebuild_fraction"] == encoded[-1]["rebuild_fraction"]
    assert last["h2d_bytes"] == encoded[-1]["h2d_bytes"]
    assert snap["residency"]["default"]["cycle"] == last["cycle"]
    assert data_plane.LEDGER.snapshot(cycles=0)["cycles"] == []
