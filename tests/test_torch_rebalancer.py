"""`cook_tpu_torch.scheduler.rebalancer.rebalance_pool` against the
reference's on stores built from the same jobs in both packages: identical
`Decision`s (job, hostname, task ids, min_preempted_dru, victims) in the
exact mode and in `fast_cycle`, on the scenarios of
tests/test_rebalancer_fast.py and on over-quota, novel-host, attribute and
multi-victim cases; plus the scheduler's side of the rebalancer (dynamic
config, the reservation mask of the matcher, the ledger's block width).
Every input is exact in float32, so no tolerance applies."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cook_tpu.models import entities as ref_ent
from cook_tpu.models import store as ref_store
from cook_tpu.scheduler import core as ref_core
from cook_tpu.scheduler import matcher as ref_matcher
from cook_tpu.scheduler import rebalancer as ref_rb
from cook_tpu_torch.models import entities as port_ent
from cook_tpu_torch.models import store as port_store
from cook_tpu_torch.scheduler import core as port_core
from cook_tpu_torch.scheduler import matcher as port_matcher
from cook_tpu_torch.scheduler import rebalancer as port_rb
from tests.conftest import FakeClock

# one intra-op thread: the suite runs several pytest-xdist workers side
# by side, and idle OpenMP threads spinning in each would crowd them
torch.set_num_threads(1)


def _pkg(ent, store, rb, **extra):
    return SimpleNamespace(
        ent=ent, JobStore=store.JobStore, Params=rb.RebalancerParams,
        rebalance=lambda *a, **k: rb.rebalance_pool(*a, **k, **extra))


REF = _pkg(ref_ent, ref_store, ref_rb)
PORT = _pkg(port_ent, port_store, port_rb, device="cpu")
PKGS = (REF, PORT)


def _job(P, uuid, user, mem, cpus, gpus=0.0, priority=50, **kw):
    e = P.ent
    return e.Job(uuid=uuid, user=user, pool="default", priority=priority,
                 max_retries=3, command="true",
                 resources=e.Resources(mem=mem, cpus=cpus, gpus=gpus), **kw)


def _store(P, share=(400, 4, 1)):
    e = P.ent
    store = P.JobStore(clock=FakeClock())
    store.set_pool(e.Pool(name="default"))
    store.set_share(e.Share(user=e.DEFAULT_USER, pool="default",
                            resources=e.Resources(mem=share[0],
                                                  cpus=share[1],
                                                  gpus=share[2])))
    return store


def _run(store, tasks):
    """Submit and start each (job, task id, host)."""
    for job, tid, host in tasks:
        store.submit_jobs([job])
        store.create_instance(job.uuid, tid, hostname=host, node_id=host,
                              compute_cluster="m")


def _sig(decisions):
    return [(d.job.uuid, d.hostname, list(d.task_ids),
             d.min_preempted_dru, d.victims) for d in decisions]


# ------------------------------------------------------------- scenarios
# each: (P, fast) -> (store, pending jobs, spare map, params, host_info);
# a scenario builds the same store in either package


def hogs(P, fast, n_hosts=4, tasks_per_host=2, pending=3, mem=320,
         quota=None, **params):
    """tests/test_rebalancer_fast.py `_build_store`: two hogs holding every
    host with distinct per-host task sizes; pending jobs of users with no
    running tasks."""
    store = _store(P)
    tasks = []
    for h in range(n_hosts):
        for k in range(tasks_per_host):
            job = _job(P, f"run-{h}-{k}", f"hog{k % 2}", 300 + 10 * h, 3)
            tasks.append((job, f"t-{h}-{k}", f"h{h}"))
    _run(store, tasks)
    if quota is not None:
        store.set_quota(P.ent.Quota(user="hog0", pool="default",
                                    resources=P.ent.Resources(mem=100,
                                                              cpus=1),
                                    count=1))
    jobs = [_job(P, f"pend-{i}", f"starved{i}" if quota is None else "hog0",
                 mem, 3) for i in range(pending)]
    store.submit_jobs(jobs)
    spare = {f"h{h}": P.ent.Resources(mem=50.0, cpus=1.0)
             for h in range(n_hosts)}
    kw = dict(safe_dru_threshold=0.0, min_dru_diff=0.01,
              max_preemption=10, fast_cycle=fast)
    kw.update(params)
    return store, jobs, spare, P.Params(**kw), None


def spare_only(P, fast):
    """tests/test_rebalancer_fast.py: a host whose spare alone covers the
    demand wins with no victims."""
    store, _, spare, params, _ = hogs(P, fast, n_hosts=2, pending=0)
    spare["h1"] = P.ent.Resources(mem=1000.0, cpus=8.0)
    jobs = [_job(P, "p0", "s", 500, 2)]
    store.submit_jobs(jobs)
    return store, jobs, spare, params, None


def live_threshold(P, fast):
    """tests/test_rebalancer_fast.py: a task whose live DRU falls below the
    threshold after an earlier same-cycle preemption is protected."""
    store = _store(P, share=(100, 100, 1))
    _run(store, [(_job(P, f"hog-{i}", "hog", mem, 0.1), f"t{i}", f"h{i}")
                 for i, mem in enumerate([200, 300, 100])])
    jobs = [_job(P, "p1", "s1", 250, 0.1), _job(P, "p2", "s2", 90, 0.1)]
    store.submit_jobs(jobs)
    spare = {f"h{i}": P.ent.Resources(mem=10.0, cpus=1.0) for i in range(3)}
    return store, jobs, spare, P.Params(
        safe_dru_threshold=3.5, min_dru_diff=0.01, max_preemption=5,
        fast_cycle=fast), None


def multi_victim(P, fast):
    """Pending jobs asking for a whole host: every decision takes a
    prefix of several tasks."""
    store = _store(P, share=(512, 4, 1))
    tasks = []
    for h in range(3):
        for k in range(4):
            job = _job(P, f"run-{h}-{k}", f"hog{k % 2}", 512 * (k + 1), 1)
            tasks.append((job, f"t-{h}-{k}", f"h{h}"))
    _run(store, tasks)
    jobs = [_job(P, f"big-{i}", f"big{i}", 4096, 3) for i in range(3)]
    store.submit_jobs(jobs)
    spare = {f"h{h}": P.ent.Resources(mem=512.0 * h, cpus=0.5)
             for h in range(3)}
    return store, jobs, spare, P.Params(
        safe_dru_threshold=0.0, min_dru_diff=0.01, max_preemption=10,
        fast_cycle=fast), None


def novel_host(P, fast):
    """The pending job failed on h3 before: the search may not pick it
    (constraints.clj:504 novel-host), though h3 holds the best victim."""
    store, _, spare, params, _ = hogs(P, fast, pending=0)
    job = _job(P, "again", "starved", 320, 3)
    store.submit_jobs([job])
    store.create_instance("again", "old-try", hostname="h3", node_id="h3",
                          compute_cluster="m")
    store.update_instance_state("old-try", P.ent.InstanceStatus.FAILED,
                                "node-removed")
    return store, [store.jobs["again"]], spare, params, None


def attribute(P, fast):
    """The pending job needs `rack=a`: only hosts h0 and h2 qualify."""
    store, _, spare, params, _ = hogs(P, fast, pending=0)
    e = P.ent
    job = _job(P, "picky", "starved", 320, 3, constraints=(
        e.JobConstraint("rack", e.ConstraintOperator.EQUALS, "a"),))
    store.submit_jobs([job])
    info = {f"h{h}": ({"rack": "a" if h % 2 == 0 else "b"}, "")
            for h in range(4)}
    return store, [job], spare, params, info


SCENARIOS = {
    # the five of tests/test_rebalancer_fast.py
    "fast-matches-exact": lambda P, f: hogs(P, f),
    "internally-consistent": lambda P, f: hogs(
        P, f, n_hosts=6, tasks_per_host=3, pending=6, mem=300,
        max_preemption=20),
    "spare-only": spare_only,
    "live-threshold": live_threshold,
    "quota-own-tasks": lambda P, f: hogs(P, f, n_hosts=2, pending=1,
                                         quota=True, max_preemption=5),
    # and the rest of the rebalancer's inputs
    "multi-victim": multi_victim,
    "novel-host": novel_host,
    "attribute": attribute,
}


def _decide(P, scenario, fast):
    store, jobs, spare, params, info = SCENARIOS[scenario](P, fast)
    decisions = P.rebalance(store, store.pools["default"], jobs, spare,
                            params, host_info=info)
    return _sig(decisions)


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_decisions_identical_to_reference(scenario, fast):
    want = _decide(REF, scenario, fast)
    got = _decide(PORT, scenario, fast)
    assert got == want
    victims = [tid for d in got for tid in d[2]]
    assert len(victims) == len(set(victims)), "victim preempted twice"
    if scenario == "spare-only":
        assert got == []  # spare-only decisions are not returned
    elif scenario == "quota-own-tasks":
        # hog0 is over quota: it may only preempt its own (even-k) tasks
        assert all(int(tid.split("-")[2]) % 2 == 0 for tid in victims)
    elif scenario == "live-threshold":
        assert "t2" not in victims
    elif scenario == "multi-victim":
        assert got and all(len(d[2]) >= 2 for d in got)
    elif scenario == "novel-host":
        assert got and all(d[1] != "h3" for d in got)
    elif scenario == "attribute":
        assert got and all(d[1] in ("h0", "h2") for d in got)
    else:
        assert got


@pytest.mark.parametrize("scenario", ["fast-matches-exact", "multi-victim"])
def test_fast_cycle_equals_exact_where_order_cannot_drift(scenario):
    """tests/test_rebalancer_fast.py:54 on the port alone (the fast mode
    lists victims in sorted order, the exact one in row order)."""
    def norm(sig):
        return [(job, host, sorted(tids), score)
                for job, host, tids, score, _ in sig]

    assert norm(_decide(PORT, scenario, True)) == \
        norm(_decide(PORT, scenario, False))


def test_resident_mirror_is_not_ported():
    """The resident row mirror is ported now (tests/
    test_torch_resident_mirrors.py holds it to the reference): with
    `resident=True` and no mirror passed, the cycle uploads its tensors
    as with `resident=False`, as the reference's does, and decides the
    same; with a mirror, too."""
    from cook_tpu_torch.scheduler.device_state import ResidentRows

    sigs = []
    for resident, mirror in ((False, None), (True, None),
                             (True, ResidentRows("rebalance:t",
                                                 device="cpu"))):
        store, jobs, spare, params, _ = hogs(PORT, False,
                                             resident=resident)
        sigs.append(_sig(port_rb.rebalance_pool(
            store, store.pools["default"], jobs, spare, params,
            resident=mirror, device="cpu")))
    assert sigs[0] and sigs[0] == sigs[1] == sigs[2]


def test_padded_axes_bucket_as_the_reference():
    """T = bucket_size(tasks + max_preemption), H = bucket_size(hosts)."""
    for P, rb in ((REF, ref_rb), (PORT, port_rb)):
        store, _, spare, params, _ = hogs(P, False, n_hosts=70)
        kw = {"device": "cpu"} if rb is port_rb else {}
        cycle = rb.RebalanceCycle(store, store.pools["default"], spare,
                                  params, **kw)
        assert tuple(cycle._dev_host.shape) == (256,)   # 140 + 10 -> 256
        assert tuple(cycle._dev_spare.shape) == (128, 4)


def test_dynamic_config_overrides_params_as_the_reference():
    overrides = {"safe_dru_threshold": 0.25, "min_dru_diff": 0.125,
                 "max_preemption": 7, "fast_cycle": True,
                 "gang_enabled": False, "gang_max_admissions": 2,
                 "gang_drain_max_wait_ms": 5.0,
                 "gang_drain_wasted_factor": 3.0}
    got = []
    for core, store_mod, extra in (
            (ref_core, ref_store, {}), (port_core, port_store,
                                        {"device": "cpu"})):
        store = store_mod.JobStore(clock=FakeClock())
        sched = core.Scheduler(store, [], **extra)
        store.dynamic_config["rebalancer"] = overrides
        got.append(vars(sched._rebalancer_params()))
    assert got[0] == got[1]
    assert got[1]["max_preemption"] == 7


@pytest.mark.parametrize("n_nodes", [0, 1, 40, 200, 5000, 10_000])
def test_topology_block_width_matches_reference(n_nodes):
    """The reference at its default configuration (no block override) and
    with the `topology_block_hosts` override."""
    for hosts in (0, 96):
        assert port_matcher.topology_block_width(
            port_matcher.MatchConfig(topology_block_hosts=hosts),
            n_nodes) == ref_matcher.topology_block_width(
            ref_matcher.MatchConfig(topology_block_hosts=hosts),
            max(n_nodes, 1))


def _prepared(P, matcher, mock, ranking, reservations, **extra):
    """prepare_pool_problem on 4 free hosts with h1 reserved for job j2."""
    store = _store(P)
    jobs = [_job(P, f"j{i}", f"u{i}", 100, 1) for i in range(3)]
    store.submit_jobs(jobs)
    cluster = mock.MockCluster("m", [
        mock.MockHost(node_id=f"h{i}", hostname=f"h{i}", mem=1000, cpus=4)
        for i in range(4)], clock=store.clock)
    queue = ranking.RankedQueue(jobs=list(jobs), dru={}, capped=[])
    return matcher.prepare_pool_problem(
        store, store.pools["default"], queue, [cluster],
        matcher.MatchConfig(), matcher.PoolMatchState(num_considerable=10),
        host_reservations=reservations, **extra)


def test_reservation_mask_matches_reference():
    from cook_tpu.cluster import mock as ref_mock
    from cook_tpu.scheduler import ranking as ref_ranking
    from cook_tpu_torch.cluster import mock as port_mock
    from cook_tpu_torch.scheduler import ranking as port_ranking

    reservations = {"h1": "j2"}
    want = _prepared(REF, ref_matcher, ref_mock, ref_ranking, reservations)
    got = _prepared(PORT, port_matcher, port_mock, port_ranking,
                    reservations, device=torch.device("cpu"))
    np.testing.assert_array_equal(got.feasible, want.feasible)
    h1 = [o.hostname for o in got.nodes.offers].index("h1")
    # a reserved host accepts only its reserving job
    assert got.feasible[:, h1].tolist() == [False, False, True]
    assert got.feasible.sum() == 3 * 4 - 2
