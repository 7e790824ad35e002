"""The rebalancer's resident row mirror (`device_state.ResidentRows`) of
`cook_tpu_torch` against `cook_tpu` on the CPU.

- The reference's rebalancer cases (tests/test_resident_mirrors.py:72-
  160): the warm-cycle transfer floor (>= 90% fewer `rebalance-state`
  H2D bytes than the cold rebuild), decisions identical with the mirror
  on and off, a finished task's row riding a delta scatter — each on both
  packages, with the port's decisions, stats and bytes equal to the
  reference's.
- The `ResidentRows` contract cases (:253-349): the cold / width-changed
  / bucket-growth ladder, content hits moving zero rows and caching the
  permutation, one changed row scattering one row, key churn reusing
  slots, whole-array reuse, invalidation, the debug snapshot.
- The scheduler and simulator with `RebalancerParams.resident`: the run
  trace, the fairness ledger and the host reservations equal the
  `resident=False` run's and the reference simulator's.
- The configuration: the match keys `device_residency` and `quantized`,
  the parity floor and the rebalancer's defaults.

The elastic planner's cases of the reference file wait for the elastic
slice (ROADMAP Queue A item 9).  Every input is exact in float32: all
comparisons are exact."""
from types import SimpleNamespace

import numpy as np
import torch

from cook_tpu.models import entities as ref_ent
from cook_tpu.models import store as ref_store
from cook_tpu.obs import data_plane as ref_dp
from cook_tpu.scheduler import core as ref_core
from cook_tpu.scheduler import device_state as ref_ds
from cook_tpu.scheduler import rebalancer as ref_rb
from cook_tpu.sim import loadgen as ref_loadgen
from cook_tpu.sim import simulator as ref_sim
from cook_tpu.utils import config as ref_config
from cook_tpu_torch.models import entities as port_ent
from cook_tpu_torch.models import store as port_store
from cook_tpu_torch.obs import data_plane as port_dp
from cook_tpu_torch.scheduler import core as port_core
from cook_tpu_torch.scheduler import device_state as port_ds
from cook_tpu_torch.scheduler import rebalancer as port_rb
from cook_tpu_torch.sim import loadgen as port_loadgen
from cook_tpu_torch.sim import simulator as port_sim
from cook_tpu_torch.utils import config as port_config
from tests.conftest import FakeClock

# one intra-op thread: the suite runs several pytest-xdist workers side
# by side, and idle OpenMP threads spinning in each would crowd them
torch.set_num_threads(1)

REF = SimpleNamespace(ent=ref_ent, store=ref_store, dp=ref_dp,
                      core=ref_core, ds=ref_ds, rb=ref_rb, sim=ref_sim,
                      loadgen=ref_loadgen, kw={})
PORT = SimpleNamespace(ent=port_ent, store=port_store, dp=port_dp,
                       core=port_core, ds=port_ds, rb=port_rb, sim=port_sim,
                       loadgen=port_loadgen, kw={"device": "cpu"})
BOTH = (REF, PORT)
STATS = ("rebuild", "reason", "delta_rows", "resident_rows", "jobs",
         "resident_bytes")


def both(fn):
    return fn(REF), fn(PORT)


def fam_h2d(P, family):
    return P.dp.LEDGER.family_totals().get(family, {}).get("h2d_bytes", 0)


def mirror(P, name, family=None):
    return P.ds.ResidentRows(name, family=family, **P.kw)


def last(m):
    return {k: m.last.get(k) for k in STATS}


# ------------------------------------------------------------ rebalancer


def _rebalance_rig(P, n_hosts=8, tasks_per_host=4):
    """Hog users holding every host (the reference's rig, with fixed
    uuids so both packages build the same store): the cycle-START victim
    tensors are the mirror's payload."""
    e = P.ent
    store = P.store.JobStore(clock=FakeClock())
    store.set_pool(e.Pool(name="default"))
    store.set_share(e.Share(user=e.DEFAULT_USER, pool="default",
                            resources=e.Resources(mem=400, cpus=4, gpus=1)))
    for h in range(n_hosts):
        for k in range(tasks_per_host):
            job = e.Job(uuid=f"run-{h}-{k}", user=f"hog{k % 2}",
                        pool="default", priority=50, max_retries=1,
                        command="true",
                        resources=e.Resources(mem=300 + 10 * h, cpus=3))
            store.submit_jobs([job])
            store.create_instance(job.uuid, f"t-{h}-{k}",
                                  hostname=f"h{h}", node_id=f"h{h}",
                                  compute_cluster="m")
    spare = {f"h{h}": e.Resources(mem=50.0, cpus=1.0)
             for h in range(n_hosts)}
    return store, spare


def _pending(P, store, tag, n=4):
    jobs = [P.ent.Job(uuid=f"{tag}-{i}", user=f"starved{i}",
                      pool="default", priority=50, max_retries=1,
                      command="true",
                      resources=P.ent.Resources(mem=300, cpus=2))
            for i in range(n)]
    store.submit_jobs(jobs)
    return jobs


def _decisions(decisions):
    return [(d.job.uuid, d.hostname, sorted(d.task_ids),
             d.min_preempted_dru, d.victims) for d in decisions]


def _params(P, resident, max_preemption=8):
    return P.rb.RebalancerParams(safe_dru_threshold=0.0, min_dru_diff=0.01,
                                 max_preemption=max_preemption,
                                 resident=resident)


def test_rebalancer_warm_cycles_cut_h2d_by_90_percent():
    """A warm unchanged-fleet cycle moves >= 90% fewer rebalance-state
    H2D bytes than the cold rebuild cycle; each cycle's bytes and stats
    equal the reference's."""
    def run(P):
        store, spare = _rebalance_rig(P)
        m = mirror(P, f"rebalance:warm-{id(P)}", P.dp.FAM_REBALANCE)
        pool = store.pools["default"]
        out = []
        for _ in range(3):
            b0 = fam_h2d(P, P.dp.FAM_REBALANCE)
            P.rb.rebalance_pool(store, pool, [], dict(spare),
                                _params(P, True), resident=m, **P.kw)
            out.append((fam_h2d(P, P.dp.FAM_REBALANCE) - b0, last(m)))
        return out

    ref, port = both(run)
    assert port == ref
    (cold, cold_stats), *warm = port
    assert cold > 0 and (cold_stats["rebuild"], cold_stats["reason"]) == (
        True, "cold")
    for h2d, stats in warm:
        assert stats["rebuild"] is False and stats["delta_rows"] == 0
        assert h2d <= 0.1 * cold


def test_rebalancer_classic_upload_is_accounted_like_the_reference():
    """The resident=False path uploads the same tensors under the same
    family: its per-cycle rebalance-state bytes equal the reference's and
    the resident path's cold cycle."""
    def run(P):
        store, spare = _rebalance_rig(P)
        b0 = fam_h2d(P, P.dp.FAM_REBALANCE)
        P.rb.rebalance_pool(store, store.pools["default"], [], dict(spare),
                            _params(P, False), **P.kw)
        return fam_h2d(P, P.dp.FAM_REBALANCE) - b0

    ref, port = both(run)
    assert port == ref > 0


def test_rebalancer_decisions_identical_resident_on_off():
    """Identical preemption decisions (job, host, victims, score, victim
    details) with the mirror on or off, across cold, warm and
    post-termination cycles, on both packages."""
    def run(P, resident_on):
        store, spare = _rebalance_rig(P, n_hosts=6, tasks_per_host=3)
        params = _params(P, resident_on, max_preemption=10)
        m = (mirror(P, f"rebalance:parity-{id(P)}-{resident_on}",
                    P.dp.FAM_REBALANCE) if resident_on else None)
        pool = store.pools["default"]
        sigs = []
        for i in range(3):
            if i == 2:
                store.update_instance_state("t-0-0",
                                            P.ent.InstanceStatus.SUCCESS)
            pending = _pending(P, store, f"c{i}", n=3)
            decisions = P.rb.rebalance_pool(store, pool, pending,
                                            dict(spare), params,
                                            resident=m, **P.kw)
            sigs.append(_decisions(decisions))
            store.kill_jobs([job.uuid for job in pending])
        return sigs

    port_on = run(PORT, True)
    assert any(port_on), "scenario must produce preemptions"
    assert port_on == run(PORT, False)
    assert port_on == run(REF, True) == run(REF, False)


def test_rebalancer_termination_is_delta_scatter_not_rebuild():
    """A finished task's row rides the in-place scatter: no rebuild,
    O(changed-rows) delta (the task's user's rows shift with the shared
    DRU trajectory), fewer bytes than the cold cycle — as the
    reference's."""
    def run(P):
        store, spare = _rebalance_rig(P)
        m = mirror(P, f"rebalance:delta-{id(P)}", P.dp.FAM_REBALANCE)
        pool = store.pools["default"]
        out = []
        for i in range(3):
            if i == 2:
                store.update_instance_state("t-0-0",
                                            P.ent.InstanceStatus.SUCCESS)
            b0 = fam_h2d(P, P.dp.FAM_REBALANCE)
            P.rb.rebalance_pool(store, pool, [], dict(spare),
                                _params(P, True), resident=m, **P.kw)
            out.append((fam_h2d(P, P.dp.FAM_REBALANCE) - b0, last(m)))
        return out

    ref, port = both(run)
    assert port == ref
    (cold, _), _, (delta_bytes, stats) = port
    assert stats["rebuild"] is False
    assert 1 <= stats["delta_rows"] <= 16
    assert delta_bytes < cold


def test_resident_tensors_equal_the_classic_upload():
    """The cycle-start tensors the mirror serves (after churn: a finished
    task, a new task) equal the classic upload element for element, the
    slack rows' -1 host sentinel included; the shared resident spare is
    never written by the cycle's decisions."""
    store, spare = _rebalance_rig(PORT, n_hosts=4, tasks_per_host=3)
    m = mirror(PORT, "rebalance:tensors")
    pool = store.pools["default"]
    for step in range(3):
        if step == 1:
            store.update_instance_state("t-1-1",
                                        PORT.ent.InstanceStatus.SUCCESS)
        if step == 2:
            job = PORT.ent.Job(uuid="new", user="hog1", pool="default",
                               command="true",
                               resources=PORT.ent.Resources(mem=310,
                                                            cpus=3))
            store.submit_jobs([job])
            store.create_instance("new", "t-new", hostname="h2",
                                  node_id="h2", compute_cluster="m")
        cycles = [port_rb.RebalanceCycle(store, pool, dict(spare),
                                         _params(PORT, resident),
                                         device="cpu",
                                         resident=m if resident else None)
                  for resident in (True, False)]
        for name in ("_dev_host", "_dev_res", "_dev_dru", "_dev_elig",
                     "_dev_spare", "_dev_host_ok"):
            got, want = (getattr(c, name) for c in cycles)
            assert got.dtype == want.dtype and torch.equal(got, want), name
    resident_spare = m.whole_array("spare", cycles[1]._spare_np)
    pending = _pending(PORT, store, "p")
    port_rb.rebalance_pool(store, pool, pending, dict(spare),
                           _params(PORT, True), resident=m, device="cpu")
    assert m.whole_array("spare", cycles[1]._spare_np) is resident_spare
    assert torch.equal(resident_spare,
                       torch.as_tensor(cycles[1]._spare_np))


# ------------------------------------------------- ResidentRows contract


def _cols(vals):
    return {"a": np.asarray(vals, dtype=np.float32),
            "b": np.arange(len(vals), dtype=np.int32)}


def test_rebuild_ladder_reasons():
    def run(P):
        rows = mirror(P, "ladder")
        out = [rows.build(["k0", "k1"], _cols([1.0, 2.0]), out_len=4)[1]]
        # column set change -> width-changed
        out.append(rows.build(["k0"], {"a": np.zeros(1, np.float32)},
                              out_len=4)[1])
        # key count past the row bucket -> bucket-growth
        keys = [f"g{i}" for i in range(130)]
        out.append(rows.build(keys, {"a": np.arange(130, dtype=np.float32)},
                              out_len=256)[1])
        return [{k: s[k] for k in STATS} for s in out]

    ref, port = both(run)
    assert port == ref
    assert [(s["rebuild"], s["reason"]) for s in port] == [
        (True, "cold"), (True, "width-changed"), (True, "bucket-growth")]


def test_content_hit_moves_zero_rows_and_caches_perm():
    def run(P):
        rows = mirror(P, "warm", P.dp.FAM_OTHER)
        out1, s1 = rows.build(["x", "y"], _cols([3.0, 4.0]), out_len=8)
        m0 = fam_h2d(P, P.dp.FAM_OTHER)
        out2, s2 = rows.build(["x", "y"], _cols([3.0, 4.0]), out_len=8)
        warm = fam_h2d(P, P.dp.FAM_OTHER) - m0
        assert out1["a"] is not out2["a"]   # FRESH gathers
        return (s1["delta_rows"], s2["rebuild"], s2["delta_rows"], warm,
                np.asarray(out2["a"]).tolist(),
                np.asarray(out2["b"]).tolist())

    ref, port = both(run)
    assert port == ref
    assert port[:4] == (2, False, 0, 0)
    assert port[4] == [3.0, 4.0] + [0.0] * 6   # pad rows gather zeros


def test_gathers_are_fresh_tensors():
    rows = mirror(PORT, "fresh")
    out, _ = rows.build(["x", "y"], _cols([3.0, 4.0]), out_len=4)
    out["a"][0] = -1.0
    again, _ = rows.build(["x", "y"], _cols([3.0, 4.0]), out_len=4)
    assert float(again["a"][0]) == 3.0


def test_changed_row_scatters_only_that_row():
    def run(P):
        rows = mirror(P, "delta")
        rows.build(["x", "y", "z"], _cols([1.0, 2.0, 3.0]), out_len=4)
        out, s = rows.build(["x", "y", "z"], _cols([1.0, 9.0, 3.0]),
                            out_len=4)
        return s["rebuild"], s["delta_rows"], np.asarray(out["a"]).tolist()

    ref, port = both(run)
    assert port == ref == (False, 1, [1.0, 9.0, 3.0, 0.0])


def test_key_churn_reuses_slots_without_rebuild():
    """Departed keys' slots recycle LRU-first: a rolling key window
    churns through the bucket with delta-sized scatters, no rebuild."""
    def run(P):
        rows = mirror(P, "churn")
        rows.build([f"k{i}" for i in range(48)],
                   {"a": np.arange(48, dtype=np.float32)}, out_len=64)
        out = []
        for step in (1, 2, 3):
            keys = [f"k{i}" for i in range(step * 16, step * 16 + 48)]
            got, s = rows.build(
                keys, {"a": np.arange(step * 16, step * 16 + 48,
                                      dtype=np.float32)}, out_len=64)
            out.append((s["rebuild"], s["delta_rows"],
                        np.asarray(got["a"]).tolist(),
                        # the slot each key holds, in LRU order: the
                        # evictions the reference's oldest-first scan makes
                        [(key, slot[0]) for key, slot in rows._slots.items()]))
        return out

    ref, port = both(run)
    assert port == ref
    assert [(r, d) for r, d, _, _ in port] == [(False, 16)] * 3


def test_whole_array_reuses_identical_content():
    for P in BOTH:
        rows = mirror(P, "arrays")
        a = np.arange(16, dtype=np.float32)
        d1 = rows.whole_array("supply", a)
        d2 = rows.whole_array("supply", a.copy())
        assert d1 is d2
        d3 = rows.whole_array("supply", a + 1)
        assert d3 is not d1
        np.testing.assert_array_equal(np.asarray(d3), a + 1)


def test_invalidate_forces_cold_rebuild():
    for P in BOTH:
        rows = mirror(P, "inval")
        rows.build(["k"], {"a": np.ones(1, np.float32)}, out_len=2)
        rows.invalidate()
        _, s = rows.build(["k"], {"a": np.ones(1, np.float32)}, out_len=2)
        assert (s["rebuild"], s["reason"]) == (True, "cold")


def test_snapshot_all_lists_row_mirrors():
    def run(P):
        m = mirror(P, "rebalance:debug", P.dp.FAM_REBALANCE)
        m.build(["t1", "t2"], _cols([1.0, 2.0]), out_len=4)
        m.whole_array("spare", np.ones(3, np.float32))
        snap = P.ds.snapshot_all()
        assert snap["enabled"]
        mine = [r for r in snap["row_mirrors"]
                if r["name"] == "rebalance:debug"]
        assert len(mine) == 1
        row = dict(mine[0])
        row["last"] = {k: row["last"][k] for k in STATS}
        row["columns"] = {k: (tuple(v["shape"]), v["dtype"])
                          for k, v in row["columns"].items()}
        return row

    ref, port = both(run)
    assert port == ref
    assert port["family"] == port_dp.FAM_REBALANCE
    assert port["resident_bytes"] > 0 and port["slots"] == 2
    assert set(port["columns"]) == {"a", "b"}
    assert port["arrays"]["spare"] > 0 and port["last"]["rebuild"] is True


# ------------------------------------------- the scheduler and simulator


def _scheduler_rebalance(P, resident):
    """Scheduler.rebalance_cycle on a hog-filled fleet, three cycles (a
    task finishing before the last): decisions, the fairness ledger's
    entries and the host reservations."""
    store, spare = _rebalance_rig(P, n_hosts=6, tasks_per_host=3)
    scheduler = P.core.Scheduler(store, [], P.core.SchedulerConfig(
        rebalancer=_params(P, resident, max_preemption=10),
        device_telemetry=False), **P.kw)
    pool = store.pools["default"]
    out = []
    for i in range(3):
        if i == 2:
            store.update_instance_state("t-0-0",
                                        P.ent.InstanceStatus.SUCCESS)
        pending = _pending(P, store, f"c{i}", n=3)
        scheduler.pool_queues["default"] = P.core.RankedQueue(
            jobs=pending, dru={}, capped=[], quarantined=[])
        scheduler.last_unmatched_offers["default"] = dict(spare)
        decisions = scheduler.rebalance_cycle(pool)
        out.append((_decisions(decisions), dict(scheduler.host_reservations)))
    ledger = scheduler.fairness.snapshot()["pools"]["default"]["ledger"]
    mirrors = sorted(getattr(scheduler, "_rebalance_mirrors", {}) or {})
    return out, ledger, mirrors


def test_scheduler_rebalance_cycle_with_the_resident_mirror():
    port_on = _scheduler_rebalance(PORT, True)
    assert any(d for d, _ in port_on[0])
    assert port_on[2] == ["default"]   # one mirror, owned by the scheduler
    assert port_on[:2] == _scheduler_rebalance(PORT, False)[:2]
    assert port_on == _scheduler_rebalance(REF, True)


def _sim_rebalance(P, resident, trace):
    from chip_smoke import RebalanceLog, ledger_view, whole_host_trace

    if trace == "whole-host":
        jobs, hosts = whole_host_trace(P.sim.TraceJob, P.sim.TraceHost,
                                       hosts=8)
        cycles, share, dynamic = 8, (8 * 65_536 / 500, 8 * 32 / 500), None
    else:
        jobs, hosts = P.loadgen.preemption_heavy_trace(
            hog_jobs=8, late_jobs=3, hosts=4, runtime_ms=240_000,
            late_arrival_ms=30_000, n_late_users=3)
        cycles, share = 60, (500.0, 2.0)
        dynamic = {"safe_dru_threshold": 0.0, "min_dru_diff": 0.01,
                   "max_preemption": 10}
    s = P.sim.Simulator(jobs, hosts, P.sim.SimConfig(
        rebalance_every=1, max_cycles=cycles,
        scheduler=P.core.SchedulerConfig(
            use_columnar_index=False,
            rebalancer=P.rb.RebalancerParams(resident=resident))), **P.kw)
    s.store.set_share(P.ent.Share(user=P.ent.DEFAULT_USER, pool="default",
                                  resources=P.ent.Resources(
                                      mem=share[0], cpus=share[1])))
    if dynamic is not None:
        s.store.dynamic_config["rebalancer"] = dynamic
    log = RebalanceLog(s)
    result = s.run()
    return (result.to_csv(), ledger_view(result), log.reservations,
            [{k: v for k, v in c.items() if k != "wall_s"}
             for c in log.cycles])


def test_simulator_rebalance_with_resident_mirror_matches_reference():
    for trace in ("whole-host", "preemption-heavy"):
        port_on = _sim_rebalance(PORT, True, trace)
        assert sum(c["victims"] for c in port_on[3]) > 0
        assert port_on == _sim_rebalance(PORT, False, trace)
        assert port_on == _sim_rebalance(REF, True, trace)


# ------------------------------------------------------- configuration


def test_config_keys_match_the_reference():
    """The match keys `device_residency` and `quantized` load as the
    reference's `default_match_config` loads them; the parity guard's
    floor is the reference's `quantization_parity_floor` default; the
    rebalancer's defaults (`resident` off) are the reference's."""
    match = {"device_residency": True, "quantized": True}
    got = port_config.default_match_config(**match)
    want = ref_config.default_match_config(**match)
    for key in match:
        assert getattr(got, key) == getattr(want, key) == match[key]
    defaults = port_config.default_match_config()
    assert (defaults.device_residency, defaults.quantized) == (False, False)
    assert port_ds.QUANTIZATION_PARITY_FLOOR == \
        ref_config.default_match_config().quantization_parity_floor
    assert vars(port_rb.RebalancerParams()) == \
        vars(ref_rb.RebalancerParams())
