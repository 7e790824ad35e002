"""Device-resident match state of `cook_tpu_torch` against `cook_tpu` on
the CPU (`scheduler/device_state.py`, `ops/device_update.py`, the
encode cache's serve report and subscribers, the quality monitor's sample
listeners, the bfloat16 cost tensors).

Each case runs the reference's `resident_rig` (tests/test_device_state.py)
on both packages with the same inputs and compares what the residency
contract names: the placements, the cycle records' `device_state` fields
(`rebuild`, `reason`, `delta_rows`, `resident_rows`, `jobs`,
`quantized`, `resident_bytes`) and the per-cycle encode H2D bytes per
family (node-encode, job-feasibility).  The contracts the reference's
tests hold are held on the port too: warm encode H2D <= 0.1x the cold
cycle's, resident placements = classic placements, one update program
per bucket, demotion below the parity floor and none above it.  The
speculation cases and the fused-fine-backend cases of the reference file
are out of this slice (ROADMAP).

Every compared value is an integer, a bool or a string: all comparisons
are exact."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cook_tpu.cluster import mock as ref_mock
from cook_tpu.models import entities as ref_ent
from cook_tpu.models import store as ref_store
from cook_tpu.obs import data_plane as ref_dp
from cook_tpu.scheduler import core as ref_core
from cook_tpu.scheduler import device_state as ref_ds
from cook_tpu.scheduler import encode_cache as ref_ec
from cook_tpu.scheduler import matcher as ref_matcher
from cook_tpu.sim import loadgen as ref_loadgen
from cook_tpu.sim import simulator as ref_sim
from cook_tpu_torch.cluster import mock as port_mock
from cook_tpu_torch.models import entities as port_ent
from cook_tpu_torch.models import store as port_store
from cook_tpu_torch.obs import data_plane as port_dp
from cook_tpu_torch.ops import common as port_common
from cook_tpu_torch.ops import device_update as port_du
from cook_tpu_torch.scheduler import core as port_core
from cook_tpu_torch.scheduler import device_state as port_ds
from cook_tpu_torch.scheduler import encode_cache as port_ec
from cook_tpu_torch.scheduler import matcher as port_matcher
from cook_tpu_torch.sim import loadgen as port_loadgen
from cook_tpu_torch.sim import simulator as port_sim
from tests.conftest import FakeClock

# one intra-op thread: the suite runs several pytest-xdist workers side
# by side, and idle OpenMP threads spinning in each would crowd them
torch.set_num_threads(1)

# the reference's MatchConfig has the exact-kernel audit thread, which the
# port has not got: the reference's own rig turns it off
REF = SimpleNamespace(ent=ref_ent, store=ref_store, mock=ref_mock,
                      dp=ref_dp, core=ref_core, ds=ref_ds, ec=ref_ec,
                      matcher=ref_matcher, sim=ref_sim, loadgen=ref_loadgen,
                      kw={}, mkw={"quality_audit_every": 0})
PORT = SimpleNamespace(ent=port_ent, store=port_store, mock=port_mock,
                       dp=port_dp, core=port_core, ds=port_ds, ec=port_ec,
                       matcher=port_matcher, sim=port_sim,
                       loadgen=port_loadgen, kw={"device": "cpu"}, mkw={})
BOTH = (REF, PORT)
FIELDS = ("rebuild", "reason", "delta_rows", "resident_rows", "jobs",
          "quantized", "resident_bytes")


def fam_h2d(P) -> dict:
    totals = P.dp.LEDGER.family_totals()
    return {f: totals.get(f, {}).get("h2d_bytes", 0)
            for f in (P.dp.FAM_NODE_ENCODE, P.dp.FAM_FEASIBILITY)}


def resident_rig(P, n_jobs=200, n_hosts=8, host_mem=4096.0, *,
                 resident=True, quantized=False, telemetry=False,
                 chunk=0, job_mem=4000.0, backend="xla",
                 max_jobs_considered=1000, **sched_kw):
    """The reference's rig: a Scheduler and near-host-size jobs — a
    handful match on the cold cycle, the rest wait, so warm cycles see an
    unchanged pool."""
    store = P.store.JobStore(clock=lambda: 1_000_000)
    store.set_pool(P.ent.Pool(name="default"))
    cluster = P.mock.MockCluster(
        "m",
        [P.mock.MockHost(node_id=f"h{i}", hostname=f"h{i}", mem=host_mem,
                         cpus=8.0) for i in range(n_hosts)],
        clock=store.clock)
    config = P.core.SchedulerConfig(
        match=P.matcher.MatchConfig(
            chunk=chunk, device_residency=resident, quantized=quantized,
            backend=backend, max_jobs_considered=max_jobs_considered,
            **P.mkw),
        device_telemetry=telemetry, **sched_kw)
    scheduler = P.core.Scheduler(store, [cluster], config, **P.kw)
    store.submit_jobs([
        P.ent.Job(uuid=f"j{i}", user=f"u{i % 4}", pool="default",
                  priority=50,
                  resources=P.ent.Resources(mem=job_mem, cpus=8.0),
                  command="true")
        for i in range(n_jobs)
    ])
    return store, scheduler


def run_cycle(P, store, scheduler):
    """One rank + match cycle: (sorted (job, host) pairs, the record's
    compared device_state fields, the cycle's encode H2D bytes per
    family)."""
    pool = store.pools["default"]
    before = fam_h2d(P)
    scheduler.rank_cycle(pool)
    outcome = scheduler.match_cycle(pool)
    after = fam_h2d(P)
    record = scheduler.recorder.records(limit=1)[0]
    fields = {k: record.device_state.get(k) for k in FIELDS}
    return (sorted((j.uuid, o.hostname) for j, o in outcome.matched),
            fields, {f: after[f] - before[f] for f in after})


def submit(P, store, uuids, mem=4000.0):
    store.submit_jobs([
        P.ent.Job(uuid=u, user="d", pool="default", priority=50,
                  resources=P.ent.Resources(mem=mem, cpus=8.0),
                  command="true") for u in uuids])


def both(fn):
    """fn(P) on the reference and on the port."""
    return fn(REF), fn(PORT)


# --------------------------------------------------- warm-cycle transfers


def test_warm_cycles_cut_encode_h2d_by_90_percent():
    """THE acceptance bar: a warm unchanged-pool cycle moves >= 90% fewer
    node-encode + job-feasibility H2D bytes than the cold rebuild cycle,
    and each cycle's bytes per family equal the reference's."""
    def run(P):
        store, scheduler = resident_rig(P, n_jobs=1000, n_hosts=16)
        return [run_cycle(P, store, scheduler) for _ in range(3)]

    ref, port = both(run)
    assert port == ref
    (_, cold_fields, cold), *warm = port
    assert cold_fields["rebuild"] is True and cold_fields["reason"] == "cold"
    for _, fields, h2d in warm:
        assert fields["rebuild"] is False and fields["delta_rows"] == 0
        assert sum(h2d.values()) <= 0.1 * sum(cold.values())


def test_resident_placements_identical_to_classic_path():
    def matched(P, resident):
        store, scheduler = resident_rig(P, n_jobs=60, n_hosts=6,
                                        job_mem=900.0, host_mem=4096.0,
                                        resident=resident)
        return [run_cycle(P, store, scheduler)[0] for _ in range(3)]

    port = matched(PORT, True)
    assert port == matched(PORT, False)
    assert port == matched(REF, True)


def test_single_new_job_is_one_delta_row():
    def run(P):
        store, scheduler = resident_rig(P)
        out = [run_cycle(P, store, scheduler) for _ in range(2)]
        submit(P, store, ["delta"])
        out.append(run_cycle(P, store, scheduler))
        return out

    ref, port = both(run)
    assert port == ref
    assert port[-1][1]["rebuild"] is False
    assert port[-1][1]["delta_rows"] == 1


def test_row_invalidation_re_uploads_only_that_row():
    """An instance/status event drops the job's feasibility rows (host
    cache AND mirror slot, via the subscriber): the next cycle scatters
    exactly the invalidated rows, no rebuild."""
    def run(P):
        store, scheduler = resident_rig(P, n_jobs=40, job_mem=900.0)
        pool = store.pools["default"]
        scheduler.rank_cycle(pool)
        outcome = scheduler.match_cycle(pool)
        assert outcome.matched
        out = [run_cycle(P, store, scheduler)]
        job = min((j for j, _ in outcome.matched), key=lambda j: j.uuid)
        inst = store.job_instances(job.uuid)[0]
        store.update_instance_state(inst.task_id,
                                    P.ent.InstanceStatus.FAILED,
                                    "preempted-by-rebalancer")
        out.append(run_cycle(P, store, scheduler))
        return out

    ref, port = both(run)
    assert port == ref
    fields = port[-1][1]
    assert fields["rebuild"] is False
    assert 1 <= fields["delta_rows"] <= 3


def test_epoch_bump_forces_clean_rebuild():
    def run(P):
        store, scheduler = resident_rig(P)
        out = [run_cycle(P, store, scheduler) for _ in range(2)]
        store.set_quota(P.ent.Quota(
            user="u0", pool="default",
            resources=P.ent.Resources(mem=10_000.0, cpus=100.0),
            count=1000))
        out.append(run_cycle(P, store, scheduler))
        return out

    ref, port = both(run)
    assert port == ref
    assert port[1][1]["rebuild"] is False
    assert (port[2][1]["rebuild"], port[2][1]["reason"]) == (
        True, "epoch-bumped")


def test_offer_structure_change_forces_rebuild():
    def run(P):
        store, scheduler = resident_rig(P, n_hosts=4)
        out = [run_cycle(P, store, scheduler)]
        host = P.mock.MockHost(node_id="grow", hostname="grow", mem=4096.0,
                               cpus=8.0)
        scheduler.clusters[0].hosts[host.node_id] = host
        out.append(run_cycle(P, store, scheduler))
        return out

    ref, port = both(run)
    assert port == ref
    assert (port[1][1]["rebuild"], port[1][1]["reason"]) == (
        True, "offers-changed")


def test_job_bucket_growth_forces_rebuild():
    def run(P):
        store, scheduler = resident_rig(P, n_jobs=60)
        out = [run_cycle(P, store, scheduler)]
        # push the considerable window past the padded job bucket
        # (64 -> 128)
        submit(P, store, [f"grow{i}" for i in range(30)])
        out.append(run_cycle(P, store, scheduler))
        return out

    ref, port = both(run)
    assert port == ref
    cold, grown = port[0][1], port[1][1]
    assert (grown["rebuild"], grown["reason"]) == (True, "bucket-growth")
    assert grown["resident_bytes"] > cold["resident_bytes"]


def test_mirror_serves_classic_problem_tensors():
    """Residency is a transfer optimisation: on every cycle of a rig with
    churn (new jobs, a failed instance, a quota bump), the mirror's
    problem tensors equal the classic build's element for element (pad
    rows read the all-zero pad row, not merely job_valid-masked)."""
    def problems(resident):
        store, scheduler = resident_rig(PORT, n_jobs=40, job_mem=900.0,
                                        resident=resident)
        built = []
        real = port_matcher.build_match_problem
        state = scheduler.device_state

        def tap(problem):
            built.append([None if t is None else t.clone()
                          for t in problem])
            return problem

        if state is not None:
            orig = state.build_problem
            state.build_problem = lambda *a, **k: tap(orig(*a, **k))
        else:
            port_matcher.build_match_problem = \
                lambda *a, **k: tap(real(*a, **k))
        try:
            for cycle in range(5):
                if cycle == 2:
                    submit(PORT, store, ["late0", "late1"], mem=900.0)
                if cycle == 3:
                    inst = next(iter(store.instances.values()))
                    store.update_instance_state(
                        inst.task_id, PORT.ent.InstanceStatus.FAILED,
                        "preempted-by-rebalancer")
                if cycle == 4:
                    store.set_quota(PORT.ent.Quota(
                        user="u1", pool="default",
                        resources=PORT.ent.Resources(mem=1e6, cpus=1e3),
                        count=1000))
                run_cycle(PORT, store, scheduler)
        finally:
            port_matcher.build_match_problem = real
        return built

    resident, classic = problems(True), problems(False)
    assert len(resident) == len(classic) == 5
    for got, want in zip(resident, classic):
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            if g is not None:
                assert g.dtype == w.dtype
                assert torch.equal(g, w)


# ------------------------------------------------ compile-program pinning


def test_delta_updates_stay_on_one_program_per_bucket():
    """Delta sizes 1..4 share ONE update bucket (UPDATE_BUCKET_MIN=8), so
    the observatory counts one update program per resident buffer — not
    one per delta size — on both packages."""
    def run(P):
        store, scheduler = resident_rig(P, n_jobs=40, telemetry=True)
        run_cycle(P, store, scheduler)
        observatory = scheduler.telemetry.observatory
        out = []
        for delta, tag in ((1, "a"), (2, "b"), (3, "c"), (4, "d")):
            submit(P, store, [f"{tag}-{i}" for i in range(delta)])
            _, fields, _ = run_cycle(P, store, scheduler)
            out.append((fields["rebuild"], fields["delta_rows"],
                        observatory.stats()["device_update"]["programs"]))
        return out

    ref, port = both(run)
    assert port == ref
    assert [p for _, _, p in port] == [2, 2, 2, 2]
    assert [d for _, d, _ in port] == [1, 2, 3, 4]


# -------------------------------------------------- fingerprint contract


def test_offers_fingerprint_deterministic_and_order_sensitive():
    """Identical offer sets fingerprint identically; a different arrival
    order fingerprints differently (feasibility rows are node-indexed in
    offer order, so order IS structure)."""
    def fps(P):
        def offers(order):
            cluster = P.mock.MockCluster(
                "m", [P.mock.MockHost(node_id=f"h{i}", hostname=f"h{i}",
                                      mem=100.0, cpus=1.0) for i in order],
                clock=lambda: 0)
            return [(cluster, o) for o in cluster.pending_offers("default")]

        return [P.ec.offers_fingerprint(offers(o))
                for o in ([0, 1, 2], [0, 1, 2], [2, 1, 0])]

    for a, b, c in both(fps):
        assert a == b and a != c


def test_fingerprint_collision_with_different_node_count_rebuilds(
        monkeypatch):
    """Even if offers_fingerprint COLLIDES across a node-count change,
    both the host cache and the device mirror refuse the stale state and
    rebuild, and the rebuilt problem is shaped for the real node count."""
    for P in BOTH:
        monkeypatch.setattr(P.ec, "offers_fingerprint",
                            lambda cluster_offers: 42)

    def run(P):
        store, scheduler = resident_rig(P, n_hosts=4, n_jobs=30)
        out = [run_cycle(P, store, scheduler) for _ in range(2)]
        for i in range(3):
            host = P.mock.MockHost(node_id=f"x{i}", hostname=f"x{i}",
                                   mem=4096.0, cpus=8.0)
            scheduler.clusters[0].hosts[host.node_id] = host
        out.append(run_cycle(P, store, scheduler))
        return out

    ref, port = both(run)
    assert port == ref
    assert port[0][1]["rebuild"] is True
    assert port[1][1]["rebuild"] is False
    assert (port[2][1]["rebuild"], port[2][1]["reason"]) == (
        True, "offers-changed")
    assert {host for _, host in port[2][0]} == {"x0", "x1", "x2"}


# ----------------------------------------------------- encode-cache hook


def test_encode_cache_subscriber_callbacks():
    """The same store events reach a subscriber as the same (kind, info)
    sequence on both packages."""
    def run(P):
        store = P.store.JobStore(clock=FakeClock())
        store.set_pool(P.ent.Pool(name="default"))
        cache = P.ec.EncodeCache(store)
        events = []
        cache.subscribe(lambda kind, **info: events.append((kind, info)))
        job = P.ent.Job(uuid="j", user="u", pool="default", command="x",
                        resources=P.ent.Resources(mem=10.0, cpus=1.0))
        store.submit_jobs([job])
        store.create_instance(job.uuid, "t1", hostname="h", node_id="n",
                              compute_cluster="c")
        store.update_instance_state("t1", P.ent.InstanceStatus.FAILED,
                                    "failed")
        store.set_quota(P.ent.Quota(
            user="u", pool="default",
            resources=P.ent.Resources(mem=1.0, cpus=1.0), count=1))
        cache.clear()
        return events

    ref, port = both(run)
    assert port == ref
    assert ("row-dropped", {"job_uuid": "j"}) in port
    assert any(kind == "epoch-bumped" for kind, _ in port)


def test_subscriber_failure_never_blocks_events():
    for P in BOTH:
        store = P.store.JobStore(clock=FakeClock())
        store.set_pool(P.ent.Pool(name="default"))
        cache = P.ec.EncodeCache(store)

        def bad(kind, **info):
            raise RuntimeError("sick subscriber")

        seen = []
        cache.subscribe(bad)
        cache.subscribe(lambda kind, **info: seen.append(kind))
        cache.clear()
        assert "epoch-bumped" in seen


def test_serve_report_matches_the_reference():
    """`feasibility(served=)`: the RowServe of every cacheable job, cycle
    by cycle, equals the reference's (hits, fresh misses, a group job
    left out, a row computed across an epoch bump kept uncached)."""
    def run(P):
        store = P.store.JobStore(clock=FakeClock())
        store.set_pool(P.ent.Pool(name="default"))
        cache = P.ec.EncodeCache(store)
        jobs = [P.ent.Job(uuid=f"j{i}", user="u", pool="default",
                          command="x", group_uuid="g" if i == 3 else None,
                          resources=P.ent.Resources(mem=10.0, cpus=1.0))
                for i in range(5)]
        out = []
        for cycle in range(4):
            served = {}

            def compute(subset, pre_rows):
                if cycle == 2:
                    # an epoch bump lands while the rows are computed
                    cache.clear()
                return np.ones((len(subset), 3), dtype=bool)

            cache.feasibility("default", jobs[:4 + (cycle > 0)], 3, 7,
                              compute, served=served)
            out.append(sorted((u, tuple(s)) for u, s in served.items()))
        return out

    ref, port = both(run)
    assert port == ref


# -------------------------------------------------------- quantization


@pytest.mark.parametrize("chunk,backend", [(0, "xla"), (64, "pallas"),
                                           (64, "xla")])
def test_quantized_parity_holds_and_matches_f32_decisions(chunk, backend):
    """Packing-efficiency parity of the quantized path vs f32 >= 0.98
    (here: identical placements on the seeded problem), and the port's
    quantized placements equal the reference's."""
    def matched(P, quantized):
        store, scheduler = resident_rig(P, n_jobs=80, job_mem=700.0,
                                        host_mem=8192.0, chunk=chunk,
                                        backend=backend,
                                        quantized=quantized)
        placed, fields, _ = run_cycle(P, store, scheduler)
        if quantized:
            assert fields["quantized"] is True
        return placed

    q, f = matched(PORT, True), matched(PORT, False)
    assert len(q) >= 0.98 * len(f)
    assert q == f
    if (chunk, backend) == (64, "xla"):
        # the rig's hosts are identical, and the reference's approx_max_k
        # candidate lists order equal scores in another order than the
        # port's exact top-kc (ROADMAP Queue C port item 3): hold the
        # property on the reference, not its hosts
        assert matched(REF, True) == matched(REF, False)
    else:
        assert q == matched(REF, True)


def test_quantized_cost_tensors_cross_as_two_bytes():
    """The quantized node-encode bytes: the demands/avail/totals columns
    at 2 bytes an element, equal to the reference's on the cold and the
    warm cycle; the classic (non-resident) quantized build too."""
    def run(P, resident):
        store, scheduler = resident_rig(P, n_jobs=80, job_mem=700.0,
                                        host_mem=8192.0, quantized=True,
                                        resident=resident)
        return [run_cycle(P, store, scheduler)[2] for _ in range(2)]

    for resident in (True, False):
        assert run(PORT, resident) == run(REF, resident)
    state = resident_rig(PORT, n_jobs=80, quantized=True)[1].device_state
    assert port_ds.quantized_dtype() == torch.bfloat16
    assert state.quantized_for(
        port_matcher.MatchConfig(quantized=True), "p") is True


def test_quality_drift_demotes_quantized_pool_to_f32():
    """A QualityMonitor sample under the parity floor demotes the pool:
    the next cycle rebuilds the mirror at f32 (reason dtype-changed) and
    stays f32, as in the reference."""
    def run(P):
        store, scheduler = resident_rig(P, n_jobs=40, quantized=True,
                                        telemetry=True)
        out = [run_cycle(P, store, scheduler)]
        scheduler.telemetry.quality.record_sample("default", 0.5)
        out.append(scheduler.device_state.demoted_pools())
        out += [run_cycle(P, store, scheduler) for _ in range(2)]
        return out

    ref, port = both(run)
    assert port == ref
    assert port[0][1]["quantized"] is True
    assert port[1] == ["default"]
    assert (port[2][1]["quantized"], port[2][1]["rebuild"],
            port[2][1]["reason"]) == (False, True, "dtype-changed")
    assert (port[3][1]["quantized"], port[3][1]["rebuild"]) == (False,
                                                                 False)


def test_healthy_quality_sample_never_demotes():
    for P in BOTH:
        store, scheduler = resident_rig(P, n_jobs=20, quantized=True,
                                        telemetry=True)
        run_cycle(P, store, scheduler)
        scheduler.telemetry.quality.record_sample("default", 0.995)
        assert scheduler.device_state.demoted_pools() == []


def test_sick_quality_listener_never_costs_the_sample():
    monitor = port_core.DeviceTelemetry().quality

    def bad(pool, ratio):
        raise RuntimeError("sick listener")

    seen = []
    monitor.add_listener(bad)
    monitor.add_listener(lambda pool, ratio: seen.append((pool, ratio)))
    monitor.record_sample("p", 0.9)
    assert seen == [("p", 0.9)]
    assert monitor._last["p"] == 0.9


# ------------------------------------------------- multi-path + the sim


def test_pipelined_and_batched_paths_share_the_mirror():
    def run(P, mode):
        store = P.store.JobStore(clock=lambda: 1_000_000)
        hosts = []
        for p in range(2):
            store.set_pool(P.ent.Pool(name=f"pool{p}"))
            hosts += [P.mock.MockHost(node_id=f"p{p}h{i}",
                                      hostname=f"p{p}h{i}",
                                      mem=8192.0 + 512 * i, cpus=16.0,
                                      pool=f"pool{p}")
                      for i in range(3)]
        cluster = P.mock.MockCluster("m", hosts, clock=store.clock)
        scheduler = P.core.Scheduler(store, [cluster], P.core.SchedulerConfig(
            match=P.matcher.MatchConfig(chunk=0, device_residency=True,
                                        **P.mkw),
            device_telemetry=False), **P.kw)
        store.submit_jobs([
            P.ent.Job(uuid=f"j{p}-{i}", user=f"u{i % 3}", pool=f"pool{p}",
                      priority=50,
                      resources=P.ent.Resources(mem=600.0, cpus=1.0),
                      command="true")
            for p in range(2) for i in range(30)
        ])
        pools = [p for p in store.pools.values() if p.schedules_jobs]
        out = []
        for _ in range(2):
            for pool in pools:
                scheduler.rank_cycle(pool)
            if mode == "pipelined":
                outcomes = scheduler.match_cycle_pipelined()
            elif mode == "batched":
                outcomes = scheduler.match_cycle_all_pools()
            else:
                outcomes = {p.name: scheduler.match_cycle(p) for p in pools}
            out.append(sorted((j.uuid, o.hostname)
                              for o2 in outcomes.values()
                              for j, o in o2.matched))
        return out

    serial = run(PORT, "serial")
    assert run(PORT, "pipelined") == serial
    assert run(PORT, "batched") == serial
    assert serial == run(REF, "serial")


def _standard_trace(P):
    rng = np.random.default_rng(3)
    jobs = [P.sim.TraceJob(uuid=f"j{i}", user=f"u{i % 4}",
                           submit_time_ms=int(rng.integers(0, 120_000)),
                           runtime_ms=int(rng.integers(30_000, 120_000)),
                           mem=float(rng.choice([200, 400, 800])),
                           cpus=float(rng.choice([1, 2])))
            for i in range(40)]
    hosts = [P.sim.TraceHost(node_id=f"n{i}", hostname=f"n{i}", mem=2000,
                             cpus=8) for i in range(8)]
    return jobs, hosts


@pytest.mark.parametrize("trace", ["standard", "completion_heavy"])
def test_sim_trace_placements_identical_with_residency(trace):
    """The standard and completion-heavy sim traces place identically
    with residency on and off, and as the reference's resident run."""
    def run(P, resident):
        if trace == "standard":
            jobs, hosts = _standard_trace(P)
        else:
            jobs, hosts = P.loadgen.completion_heavy_trace(jobs=24, hosts=4)
        config = P.sim.SimConfig(
            cycle_ms=30_000, max_cycles=30, resident=resident,
            scheduler=P.core.SchedulerConfig(device_telemetry=False))
        result = P.sim.Simulator(jobs, hosts, config, **P.kw).run()
        return (sorted((r["job_uuid"], r["host"], r["start_ms"])
                       for r in result.rows
                       if r.get("start_ms") is not None),
                result.data_plane["device_state"])

    port, port_ds_summary = run(PORT, True)
    assert port == run(PORT, False)[0]
    ref, ref_ds_summary = run(REF, True)
    assert port == ref
    assert port_ds_summary == ref_ds_summary


def test_sim_summary_reports_device_state():
    def run(P):
        jobs = [P.sim.TraceJob(uuid=f"j{i}", user="u", submit_time_ms=0,
                               runtime_ms=60_000, mem=300.0, cpus=1.0)
                for i in range(20)]
        hosts = [P.sim.TraceHost(node_id=f"n{i}", hostname=f"n{i}",
                                 mem=1000, cpus=4) for i in range(4)]
        return P.sim.Simulator(jobs, hosts, P.sim.SimConfig(
            cycle_ms=30_000, max_cycles=20, resident=True,
            scheduler=P.core.SchedulerConfig(device_telemetry=False)),
            **P.kw).run().data_plane["device_state"]

    ref, port = both(run)
    assert port == ref
    assert port["cycles"] > 0 and port["rebuilds"] >= 1


def test_sim_resident_leaves_the_callers_config_as_given():
    config = port_sim.SimConfig(max_cycles=1, resident=True)
    sim = port_sim.Simulator([], [], config, device="cpu")
    assert sim.config.scheduler.match.device_residency is True
    assert config.scheduler.match.device_residency is False


# ---------------------------------------------------- resident DRU columns


def test_resident_array_reuses_unchanged_content():
    state = port_ds.DeviceResidentState(device="cpu")
    a = np.arange(16, dtype=np.float32)
    d1 = state.resident_array("p", "dru.mem", a)
    d2 = state.resident_array("p", "dru.mem", a.copy())
    assert d1 is d2
    d3 = state.resident_array("p", "dru.mem", a + 1)
    assert d3 is not d1
    np.testing.assert_array_equal(d3.numpy(), a + 1)
    # the cached copy is private: writing the host array changes nothing
    a[0] = 99.0
    assert float(d1[0]) == 0.0


def test_rank_cycle_moves_zero_dru_bytes_when_queue_unchanged():
    def run(P):
        store, scheduler = resident_rig(P, n_jobs=50)
        pool = store.pools["default"]

        def dru_h2d():
            return P.dp.LEDGER.family_totals().get(
                P.dp.FAM_DRU, {}).get("h2d_bytes", 0)

        t0 = dru_h2d()
        scheduler.rank_cycle(pool)
        first = dru_h2d() - t0
        scheduler.match_cycle(pool)
        scheduler.rank_cycle(pool)  # queue membership unchanged
        t1 = dru_h2d()
        scheduler.rank_cycle(pool)
        return first, dru_h2d() - t1, sorted(
            scheduler.device_state.debug_json()["resident_arrays"]
            ["default"])

    ref, port = both(run)
    assert port == ref
    assert port[0] > 0 and port[1] == 0


def test_rank_queue_identical_with_resident_columns():
    """The DRU columns served from residency rank the queue as the
    uploads do (both rank paths)."""
    for columnar in (True, False):
        queues = []
        for resident in (True, False):
            store, scheduler = resident_rig(
                PORT, n_jobs=50, resident=resident,
                use_columnar_index=columnar)
            pool = store.pools["default"]
            out = []
            for _ in range(3):
                queue = scheduler.rank_cycle(pool)
                out.append(([j.uuid for j in queue.jobs], queue.dru))
                scheduler.match_cycle(pool)
            queues.append(out)
        assert queues[0] == queues[1]


# ---------------------------------------------------------- debug surface


def test_snapshot_all_reports_mirrors():
    def run(P):
        store, scheduler = resident_rig(P, n_jobs=20)
        run_cycle(P, store, scheduler)
        snap = P.ds.snapshot_all()
        mine = scheduler.device_state.debug_json()
        assert snap["enabled"] and mine in snap["states"]
        pool = dict(mine["pools"]["default"])
        last = pool.pop("last")
        return pool, {k: last[k] for k in FIELDS}

    ref, port = both(run)
    assert port == ref
    assert port[0]["resident_bytes"] > 0 and port[1]["rebuild"] is True
    assert port[0]["dtype"] == "float32"


def test_quantized_dtype_is_two_bytes():
    assert torch.tensor([], dtype=port_ds.quantized_dtype()).element_size() \
        == ref_ds.quantized_dtype().itemsize == 2


# ------------------------------------------------------ the port's parts


def test_update_buckets_and_padding_match_the_reference():
    from cook_tpu.ops import device_update as ref_du

    for k in (1, 7, 8, 9, 31, 64, 65):
        assert port_du.update_bucket(k) == ref_du.update_bucket(k)
        idx = np.arange(k, dtype=np.int32)
        rows = np.arange(k * 3, dtype=np.float32).reshape(k, 3)
        gi, gr = port_du.pad_update(idx, rows)
        wi, wr = ref_du.pad_update(idx, rows)
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gr, wr)
        ti, tr = port_du.pad_update(idx, torch.from_numpy(rows)
                                    .to(torch.bfloat16))
        np.testing.assert_array_equal(ti, wi)
        np.testing.assert_array_equal(tr.float().numpy(), wr)


def test_scatter_in_place_with_duplicate_padding_and_fresh_gather():
    buf = torch.zeros((9, 3), dtype=torch.float32)
    same = port_du.scatter_rows(buf, np.array([4, 1, 6]),
                                np.array([[1, 2, 3], [4, 5, 6], [7, 8, 9]],
                                         dtype=np.float32))
    assert same is buf   # in place: the buffer the caller holds
    want = np.zeros((9, 3), np.float32)
    want[[4, 1, 6]] = [[1, 2, 3], [4, 5, 6], [7, 8, 9]]
    np.testing.assert_array_equal(buf.numpy(), want)
    out = port_du.gather_rows(buf, torch.tensor([6, 8, 4], dtype=torch.int32))
    np.testing.assert_array_equal(out.numpy(), want[[6, 8, 4]])
    out[0] = -1.0
    assert float(buf[6, 0]) == 7.0   # a fresh tensor, not a view


def test_scatter_bytes_are_the_padded_bucket():
    scope = port_dp.CycleDataPlane()
    buf = torch.zeros((33, 4), dtype=torch.bfloat16)
    rows = port_common.host_cast(np.ones((3, 4), np.float32),
                                 torch.bfloat16)
    with port_dp.activate(scope):
        port_du.scatter_rows(buf, np.array([0, 1, 2]), rows,
                             family=port_dp.FAM_NODE_ENCODE)
    # 8-row bucket: int32 indices + 2-byte rows
    assert scope.families_json()[port_dp.FAM_NODE_ENCODE]["h2d_bytes"] \
        == 8 * 4 + 8 * 4 * 2


def test_a_raising_build_drops_the_mirror_and_re_raises(monkeypatch):
    store, scheduler = resident_rig(PORT, n_jobs=40)
    run_cycle(PORT, store, scheduler)
    state = scheduler.device_state
    assert "default" in state._mirrors
    submit(PORT, store, ["boom"])

    def boom(*a, **k):
        raise RuntimeError("scatter failed")

    monkeypatch.setattr(port_ds, "scatter_rows", boom)
    with pytest.raises(RuntimeError, match="scatter failed"):
        run_cycle(PORT, store, scheduler)
    assert "default" not in state._mirrors
    monkeypatch.undo()
    _, fields, _ = run_cycle(PORT, store, scheduler)
    assert (fields["rebuild"], fields["reason"]) == (True, "cold")


def test_reservation_cycle_bypasses_the_mirror():
    """A host reservation narrows this cycle's rows only: the cycle builds
    the classic problem (no device_state record) and the next cycle
    rides the mirror again."""
    store, scheduler = resident_rig(PORT, n_jobs=40, job_mem=900.0)
    run_cycle(PORT, store, scheduler)
    scheduler.host_reservations["h0"] = "someone-else"
    _, fields, _ = run_cycle(PORT, store, scheduler)
    assert fields["rebuild"] is None
    scheduler.host_reservations.clear()
    _, fields, _ = run_cycle(PORT, store, scheduler)
    assert fields["rebuild"] is False


def _chunked(package, d, a, t, feas, dtype, backend, **knobs):
    """One chunked solve of both packages' `chunked_match` on the same
    inputs in `dtype` ("bfloat16" / "float32"): the assignment as a
    list."""
    knobs = {**dict(chunk=len(d), rounds=1, kc=1,
                    use_pallas=backend == "pallas",
                    bucketed=backend == "bucketed",
                    passes=2 if backend == "bucketed" else 1), **knobs}
    j, n = len(d), len(a)
    if package is REF:
        import jax.numpy as jnp
        from cook_tpu.ops import match as ref_match

        jdt = getattr(jnp, dtype)
        problem = ref_match.MatchProblem(
            demands=jnp.asarray(d, jdt), job_valid=jnp.ones(j, bool),
            avail=jnp.asarray(a, jdt), totals=jnp.asarray(t, jdt),
            node_valid=jnp.ones(n, bool), feasible=jnp.asarray(feas))
        return np.asarray(
            ref_match.chunked_match(problem, **knobs).assignment).tolist()
    from cook_tpu_torch.ops import match as port_match

    def cast(x):
        return torch.as_tensor(port_common.host_cast(
            x, getattr(torch, dtype)))

    problem = port_match.MatchProblem(
        demands=cast(d), job_valid=torch.ones(j, dtype=torch.bool),
        avail=cast(a), totals=cast(t),
        node_valid=torch.ones(n, dtype=torch.bool),
        feasible=torch.from_numpy(feas))
    return port_match.chunked_match(problem, **knobs).assignment.tolist()


@pytest.mark.parametrize("backend", ["pallas", "xla", "bucketed"])
def test_quantized_prefix_accept_on_the_smallest_input(backend):
    """ROADMAP Queue C port item 4, pinned.  Job 0 is held to host 0, jobs
    1 and 2 to host 1 (5.09375 cpus free); 3.703125 + 1.3984375 =
    5.1015625 cpus do not fit.  The port's conflict round sums in float32
    (see `ops/match.conflict_round_batched`) and rejects job 2 on every
    backend, as float32 does.  The reference's jitted round rejects it on
    `pallas` and `xla` and, in bfloat16, accepts it on `bucketed` (its
    sums there round to bfloat16: 6.578125 -> 6.5625, minus 1.4765625 ->
    5.09375)."""
    d = np.array([[1000, 1.4765625, 0, 0], [1000, 3.703125, 0, 0],
                  [1000, 1.3984375, 0, 0]], np.float32)
    a = np.array([[8192, 8.0, 0, 0], [8192, 5.09375, 0, 0]], np.float32)
    t = np.array([[8192, 8.0], [8192, 8.0]], np.float32)
    feas = np.array([[1, 0], [0, 1], [0, 1]], bool)
    for dtype in ("bfloat16", "float32"):
        assert _chunked(PORT, d, a, t, feas, dtype, backend) == [0, 1, -1]
    assert _chunked(REF, d, a, t, feas, "float32", backend) == [0, 1, -1]
    assert _chunked(REF, d, a, t, feas, "bfloat16", backend) == (
        [0, 1, 1] if backend == "bucketed" else [0, 1, -1])


def test_quantized_pallas_decision_differs_from_the_reference():
    """ROADMAP Queue C port item 4, pinned: the smallest random input (8
    jobs x 2 hosts, a seeded search) on which the port's bfloat16 chunked
    solve still places otherwise than the reference's on `pallas` (job 3:
    the reference places it on host 1, the port leaves it); in float32
    the two agree."""
    rng = np.random.default_rng(169)
    j = int(rng.choice([2, 3, 4, 6, 8]))
    n = int(rng.choice([1, 2, 3, 4]))
    d = np.stack([rng.uniform(100, 2500, j).round(1),
                  rng.uniform(0.3, 4, j).round(2), np.zeros(j),
                  np.zeros(j)], -1).astype(np.float32)
    a = np.stack([rng.uniform(1000, 9000, n).round(1),
                  rng.uniform(2, 16, n).round(2), np.zeros(n),
                  np.zeros(n)], -1).astype(np.float32)
    t = a[:, :2].copy()
    feas = np.ones((j, n), bool)
    knobs = dict(rounds=2, passes=2, kc=4)
    assert (j, n) == (8, 2)
    f32 = _chunked(PORT, d, a, t, feas, "float32", "pallas", **knobs)
    assert f32 == _chunked(REF, d, a, t, feas, "float32", "pallas", **knobs)
    assert _chunked(REF, d, a, t, feas, "bfloat16", "pallas", **knobs) == \
        [0, 1, 0, 1, -1, 0, 0, -1]
    assert _chunked(PORT, d, a, t, feas, "bfloat16", "pallas", **knobs) == \
        [0, 1, 0, -1, -1, 0, 0, -1]


def _coarse(package, d, active, bsum, btot, dtype):
    """Both packages' pallas coarse pass (`hierarchical._coarse_pallas`:
    the coarse_pass kernel's wrapper in the port, the reference's
    best_block kernel in interpret mode and its jitted conflict rounds)
    on the same inputs in `dtype`, each block's max node its sum: the
    block per job, as a list."""
    kw = dict(chunk=len(d), rounds=2, passes=2)
    valid = np.ones(len(bsum), bool)
    if package is REF:
        import jax.numpy as jnp
        from cook_tpu.ops import hierarchical as ref_hier

        jdt = getattr(jnp, dtype)
        return np.asarray(ref_hier._coarse_pallas(
            jnp.asarray(d, jdt), jnp.asarray(active), jnp.asarray(bsum, jdt),
            jnp.asarray(bsum, jdt), jnp.asarray(btot, jdt),
            jnp.asarray(valid), interpret=True, **kw)).tolist()
    from cook_tpu_torch.ops import hierarchical as port_hier

    tdt = getattr(torch, dtype)
    return port_hier._coarse_pallas(
        torch.tensor(d).to(tdt), torch.tensor(active),
        torch.tensor(bsum).to(tdt), torch.tensor(bsum).to(tdt),
        torch.tensor(btot).to(tdt), torch.tensor(valid), **kw).tolist()


def test_quantized_coarse_pass_differs_from_the_reference():
    """ROADMAP Queue C port item 4, pinned on the hierarchical route: the
    smallest input on which the port's bfloat16 coarse pass routes
    otherwise than the reference's.  Four jobs of 700 MB go to block 0
    (2,096 MB free, a bfloat16 value) or block 1 (8,192 MB).  The port's
    coarse_pass casts its inputs to float32 at the boundary and runs its
    conflict rounds in float32: 2,100 MB > 2,096 MB, two jobs route to
    block 0 and two to block 1, as both packages' float32 passes route
    them.  The reference's rounds run in bfloat16, where the third job's
    prefix sum 2,100 rounds to 2,096, and route three jobs (2,100 MB) to
    the 2,096 MB block.  The fine solve holds each host to its capacity,
    so neither package overfills a host."""
    d = np.zeros((8, 2), np.float32)
    d[:4] = [700.0, 1.0]
    active = np.arange(8) < 4
    bsum = np.array([[2096.0, 8.0], [8192.0, 8.0]], np.float32)
    btot = np.array([[8192.0, 8.0], [8192.0, 8.0]], np.float32)
    spread = [0, 0, 1, 1, -1, -1, -1, -1]
    for dtype in ("bfloat16", "float32"):
        assert _coarse(PORT, d, active, bsum, btot, dtype) == spread
    assert _coarse(REF, d, active, bsum, btot, "float32") == spread
    assert _coarse(REF, d, active, bsum, btot, "bfloat16") == \
        [0, 0, 0, 1, -1, -1, -1, -1]


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_quantized_round_never_overfills_a_host(backend):
    """The fault the card found (chip_smoke's quantized slice: 450,048 MB
    placed on a 64,000 MB host): a chunk's running demand sum, far past
    bfloat16's 8 significant bits, must not swallow a later host's
    segment.  128 jobs of 8192 MB go to a roomy host 0 (a running sum of
    2^20 MB, where bfloat16's step is 8192), then 32 jobs of 1000 MB to
    host 1, which has room for one: one places there (summed in bfloat16,
    the next three jobs' sums round back to the segment's base and four
    would)."""
    d = np.zeros((160, 4), np.float32)
    d[:128, 0], d[128:, 0] = 8192.0, 1000.0
    d[:, 1] = 0.5
    a = np.array([[1e7, 1e4, 0, 0], [1500, 1e4, 0, 0]], np.float32)
    t = a[:, :2].copy()
    feas = np.zeros((160, 2), bool)
    feas[:128, 0] = feas[128:, 1] = True
    got = np.array(_chunked(PORT, d, a, t, feas, "bfloat16", backend,
                            rounds=3))
    assert (got[:128] == 0).all()
    assert int((got[128:] == 1).sum()) == 1


# ---------------------------------------------- the kernels' bf16 boundary


def _bf16_inputs(seed, k, n, r=4):
    rng = np.random.default_rng(seed)
    d = np.stack([rng.uniform(100, 2500, k), rng.uniform(0.3, 4, k)]
                 + [rng.uniform(0, 1, k)] * (r - 2), -1).astype(np.float32)
    a = np.stack([rng.uniform(1000, 9000, n), rng.uniform(2, 16, n)]
                 + [rng.uniform(0, 2, n)] * (r - 2), -1).astype(np.float32)
    t = (a[:, :2] * 1.5).astype(np.float32)
    valid = rng.uniform(size=n) > 0.2
    feas = rng.uniform(size=(k, n)) > 0.3
    return d, a, t, valid, feas


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kernel_wrappers_take_bfloat16_like_the_reference(seed):
    """Every kernel wrapper takes bfloat16 cost tensors and casts them to
    float32 at its boundary, as the reference's Pallas calls do: on the
    same bfloat16 inputs the port's `best_node`, `best_node_batched` and
    `best_block` (their plain versions, on the CPU) return the reference
    kernels' scores and indices (interpret mode), and `coarse_pass`
    returns what it returns on the float32 values of those inputs."""
    import jax.numpy as jnp
    from cook_tpu.ops import pallas_match as ref_pm
    from cook_tpu_torch.ops import best_block as port_bb
    from cook_tpu_torch.ops import best_node as port_bn
    from cook_tpu_torch.ops import best_node_batched as port_bnb
    from cook_tpu_torch.ops import coarse_pass as port_cp

    d, a, t, valid, feas = _bf16_inputs(seed, 24, 16)

    def bf(x):
        return port_common.host_cast(x, torch.bfloat16)

    def jbf(x):
        return jnp.asarray(x, jnp.bfloat16)

    def same(got, want):
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))

    same(port_bn.best_node(bf(d), bf(a), bf(t), torch.from_numpy(valid),
                           torch.from_numpy(feas)),
         ref_pm.best_node(jbf(d), jbf(a), jbf(t), jnp.asarray(valid),
                          jnp.asarray(feas), interpret=True))
    b3 = np.stack([d[:8], d[8:16], d[16:]]), np.stack([a] * 3)
    same(port_bnb.best_node_batched(
        bf(b3[0]), bf(b3[1]), bf(np.stack([t] * 3)),
        torch.from_numpy(np.stack([valid] * 3)),
        torch.from_numpy(np.stack([feas[:8]] * 3))),
        ref_pm.best_node_batched(
            jbf(b3[0]), jbf(b3[1]), jbf(np.stack([t] * 3)),
            jnp.asarray(np.stack([valid] * 3)),
            jnp.asarray(np.stack([feas[:8]] * 3)), interpret=True))
    bmax = a / 4
    same(port_bb.best_block(bf(d), bf(a), bf(bmax), bf(t),
                            torch.from_numpy(valid)),
         ref_pm.best_block(jbf(d), jbf(a), jbf(bmax), jbf(t),
                           jnp.asarray(valid), interpret=True))
    active = torch.ones(24, dtype=torch.bool)
    got = port_cp.coarse_pass(bf(d), active, bf(a), bf(bmax), bf(t),
                              torch.from_numpy(valid), 8, 2, 2)
    want = port_cp.coarse_pass(*(bf(x).float() for x in (d,)), active,
                               *(bf(x).float() for x in (a, bmax, t)),
                               torch.from_numpy(valid), 8, 2, 2)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(TypeError):
        port_bn.best_node(bf(d).half(), bf(a), bf(t),
                          torch.from_numpy(valid))


# ------------------------------------------- chip_smoke.py's phases (CPU)


def test_chip_smoke_resident_phases_on_cpu(tmp_path):
    """chip_smoke.py's device-residency phases at a CPU test's size: the
    resident flat slice equals the classic replay, the unchanged-pool rig
    warms to zero delta rows under 0.1x the cold encode bytes, the
    quantized slice reports its packing ratio, and the resident
    default-config replay with `quantized` equals itself on two devices
    (here the CPU twice) and the replay without residency."""
    import chip_smoke
    from cook_tpu_torch.sim import cli

    trace = str(tmp_path / "small.json")
    assert cli.main(["synth", "--jobs", "1500", "--hosts", "120",
                     "--users", "50", "--submit-span-ms", "60000",
                     "--out", trace]) == 0
    slice_args = ["--considerable", "1024", "--chunk", "256", "--backend",
                  "pallas", "--max-cycles", "3", "--cycle-ms", "30000"]
    args = cli.build_parser().parse_args(
        ["run", "--trace", trace, "--out", str(tmp_path / "run.csv"),
         "--device", "cpu", *slice_args])
    _, _, result = cli.replay(args)
    classic = chip_smoke._resident_view(result, {
        "submit_s": result.phase_wall_s["submit"],
        "encode_s": result.phase_wall_s["encode"]})
    chip_smoke.resident_slice_phase(trace, str(tmp_path), classic,
                                    device="cpu", slice_args=slice_args)
    chip_smoke.unchanged_pool_phase(device="cpu", n_jobs=300, n_hosts=120,
                                    match_overrides={"chunk": 64})
    chip_smoke.quantized_slice_phase(trace, classic, device="cpu",
                                     slice_args=slice_args)
    chip_smoke.resident_default_agreement_phase(str(tmp_path),
                                                devices=("cpu", "cpu"))


def test_chip_smoke_resident_multipool_and_updaters_on_cpu():
    """chip_smoke.py's resident multi-pool phase at a CPU test's size (the
    multipool test's 4 pools, alpha on the two-level path): the resident
    serial and pipelined routes equal the classic serial route's run
    trace; and its updater phase on the CPU."""
    import chip_smoke

    pools = (("alpha", 300, 100, "default"),) + tuple(
        (f"pool{k}", 100, 20, "gpu" if k == 3 else "default")
        for k in range(1, 4))
    match = dict(hierarchical_threshold=100_000,
                 hierarchical_nodes_per_block=32)
    serial = []
    _, _, trace = chip_smoke.multipool_phase(
        device="cpu", pools=pools, match_overrides=match, serial_csv=serial)
    launches, calls = chip_smoke.resident_multipool_phase(
        *trace, serial[0], device="cpu", match_overrides=match)
    assert launches == {"best_node": 0, "coarse_pass": 0,
                        "best_node_batched": 0}
    assert all(calls[name] for name in calls)
    chip_smoke.device_update_phase(device="cpu", reps=2)


def test_chip_smoke_quantized_hier_phase_on_cpu(tmp_path):
    """chip_smoke.py's quantized hierarchical phase at a CPU test's size
    (3,000 jobs x 120 hosts, blocks of 32 nodes): the resident bfloat16
    replay overfills no host, reports its packing ratio against the
    float32 hierarchical run, and hands bfloat16 cost tensors to both
    kernels' wrappers, which give what their plain versions give on the
    float32-cast arguments."""
    import chip_smoke
    from cook_tpu_torch.ops import best_node_batched as bnb
    from cook_tpu_torch.ops import coarse_pass as cp
    from cook_tpu_torch.sim import cli

    trace = str(tmp_path / "small.json")
    assert cli.main(["synth", "--jobs", "3000", "--hosts", "120",
                     "--users", "50", "--submit-span-ms", "60000",
                     "--out", trace]) == 0
    match = dict(chip_smoke.HIER_MATCH, max_jobs_considered=1024,
                 chunk=256, hierarchical_nodes_per_block=32)
    _, _, classic, _ = chip_smoke.hier_slice_phase(
        trace, device="cpu", match_args=match)
    launches, calls = chip_smoke.quantized_hier_phase(
        trace, classic.to_csv(),
        [r["job_uuid"] for r in classic.rows if r["start_ms"] is not None],
        device="cpu", match_args=match)
    assert launches == {"best_node": 0, "best_block": 0,
                        "best_node_batched": 0, "coarse_pass": 0}
    for mod, name in ((cp, "coarse_pass"), (bnb, "best_node_batched")):
        kept = calls[name]
        assert chip_smoke.bf16_launches(kept) > 0
        for args in kept:
            got = getattr(mod, name)(*args)
            want = getattr(mod, f"{name}_reference")(*(
                a.float() if isinstance(a, torch.Tensor)
                and a.dtype == torch.bfloat16 else a for a in args))
            for g, w in zip(got, want):
                assert torch.equal(g, w)


def test_chip_smoke_resident_streams_on_cpu():
    """chip_smoke.py's resident-streams phase at a CPU test's size (2
    pools of 190 jobs x 60 hosts, 8 late jobs a pool at 30 s and 60 s):
    every warm cycle an 8-row delta on the resident serial and pipelined
    routes, and their run traces equal the classic serial one's."""
    import chip_smoke

    launches, calls = chip_smoke.resident_streams_phase(
        device="cpu", n_pools=2, jobs_per_pool=190, hosts_per_pool=60,
        late=8)
    assert launches == 0 and calls


def test_slot_evictions_match_the_reference():
    """A window that slides (a new user's jobs rank first and push the
    oldest out of the 60-job window) fills the mirror's free rows, then
    evicts the least recently served slots outside the window: each
    job's row, in LRU order, equals the reference's after every cycle."""
    def run(P):
        # one host: one launch a cycle frees one row, so the new jobs
        # outrun the free rows and the rest evict
        store, scheduler = resident_rig(P, n_jobs=60, n_hosts=1,
                                        max_jobs_considered=60)
        out = []
        for cycle in range(3):
            if cycle:
                store.submit_jobs([
                    P.ent.Job(uuid=f"z{cycle}-{i}", user=f"z{cycle}",
                              pool="default", priority=50,
                              resources=P.ent.Resources(mem=4000.0,
                                                        cpus=8.0),
                              command="true") for i in range(10)])
            _, fields, h2d = run_cycle(P, store, scheduler)
            mirror = scheduler.device_state._mirrors["default"]
            out.append((fields, h2d, [(u, slot[0]) for u, slot in
                                      mirror.slots.items()],
                        sorted(mirror.free)))
        return out

    ref, port = both(run)
    assert port == ref
    assert all(f["rebuild"] is False and f["delta_rows"] >= 9
               for f, _, _, _ in port[1:])
    assert [free for _, _, _, free in port[1:]] == [[], []]
