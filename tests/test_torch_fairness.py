"""The port's fairness observatory (`cook_tpu_torch.obs.fairness`, a copy
of `cook_tpu/obs/fairness.py` on the port's own metrics registry) checked
as tests/test_fairness.py:105-320 checks the reference's — Jain index,
ledger ring, label bounds, rollups, recovery, drift — and held to the
reference's observatory fed the same sequence: equal snapshots.  The
seeded rebalance drill runs through the port's Scheduler on the CPU and
must land the same ledger as the reference's.  Values are compared
exactly (the rollups round as the reference rounds)."""
from types import SimpleNamespace

import pytest
import torch

from cook_tpu.cluster import mock as ref_mock
from cook_tpu.models import entities as ref_ent
from cook_tpu.models import store as ref_store
from cook_tpu.obs import fairness as ref_fair
from cook_tpu.scheduler import core as ref_core
from cook_tpu_torch.cluster import mock as port_mock
from cook_tpu_torch.models import entities as port_ent
from cook_tpu_torch.models import store as port_store
from cook_tpu_torch.obs import fairness as port_fair
from cook_tpu_torch.obs.fairness import (
    FAIRNESS_DRIFT,
    FairnessConfig,
    FairnessObservatory,
    jain_index,
)
from cook_tpu_torch.scheduler import core as port_core
from cook_tpu_torch.utils.metrics import global_registry
from tests.conftest import FakeClock

# one intra-op thread: the suite runs several pytest-xdist workers side
# by side, and idle OpenMP threads spinning in each would crowd them
torch.set_num_threads(1)

REF = SimpleNamespace(ent=ref_ent, store=ref_store, fair=ref_fair,
                      core=ref_core, mock=ref_mock, kw={})
PORT = SimpleNamespace(ent=port_ent, store=port_store, fair=port_fair,
                       core=port_core, mock=port_mock, kw={"device": "cpu"})


def _ledger_entry(i: int, pool_freed_mem: float = 100.0) -> dict:
    return {
        "t_ms": 1000 + i,
        "preemptor_job": f"job-{i}",
        "preemptor_user": "starved",
        "hostname": f"h{i % 4}",
        "block": i % 3,
        "min_preempted_dru": 2.0,
        "victims": [{"task_id": f"t-{i}", "user": "hog", "dru": 2.0,
                     "wasted_s": 1.5, "mem": pool_freed_mem, "cpus": 1.0,
                     "gpus": 0.0}],
        "freed": {"mem": pool_freed_mem, "cpus": 1.0, "gpus": 0.0},
    }


class _RankStore:
    """Minimal store surface observe_rank needs: usage + share + quota."""

    def __init__(self, P, dru_by_user: dict):
        self.P = P
        self.dru_by_user = dru_by_user

    def user_usage(self, pool):
        return {u: self.P.ent.Resources(mem=d * 100.0, cpus=0.0)
                for u, d in self.dru_by_user.items()}

    def get_share(self, user, pool):
        return self.P.ent.Resources(mem=100.0, cpus=float("inf"),
                                    gpus=float("inf"))

    def get_quota(self, user, pool):
        e = self.P.ent
        return e.Quota(user=user, pool=pool,
                       resources=e.Resources(mem=float("inf"),
                                             cpus=float("inf")),
                       count=2**31)


def _rank(obs, pool, dru_by_user, P=PORT):
    queue = SimpleNamespace(jobs=[], dru={})
    obs.observe_rank(pool, queue, _RankStore(P, dru_by_user))


# ---------------------------------------------------------------- unit


@pytest.mark.parametrize("values", [[], [0.0, 0.0], [2.0, 2.0, 2.0],
                                    [100.0, 0.001, 0.001, 0.001],
                                    [1, 2, 3], [10, 20, 30], [0.5, 7.25]])
def test_jain_index_equals_reference(values):
    assert jain_index(values) == ref_fair.jain_index(values)


def test_jain_index_math():
    assert jain_index([]) == 1.0
    assert jain_index([0.0, 0.0]) == 1.0          # all-zero: vacuously fair
    assert jain_index([2.0, 2.0, 2.0]) == 1.0
    skewed = jain_index([100.0, 0.001, 0.001, 0.001])
    assert 0.25 <= skewed < 0.3                   # -> 1/n as one dominates
    assert abs(jain_index([1, 2, 3]) - jain_index([10, 20, 30])) < 1e-12


def test_ledger_ring_holds_capacity_newest_win():
    obs = FairnessObservatory(FairnessConfig(ledger_capacity=8))
    for i in range(20):
        obs.record_decisions("default", [_ledger_entry(i)])
    body = obs.snapshot(ledger_limit=100)["pools"]["default"]
    assert len(body["ledger"]) == 8
    assert [e["t_ms"] for e in body["ledger"]] == list(range(1012, 1020))
    # rollups keep counting past the ring: totals are not ring-bounded
    assert body["rollups"]["preemptions"] == 20
    assert body["rollups"]["tasks_preempted"] == 20
    assert body["rollups"]["wasted_s"]["fairness"] == 30.0


def test_trajectory_labels_age_out_and_truncate():
    obs = FairnessObservatory(FairnessConfig(max_users_per_pool=2))
    pool = "port-ageout-pool"
    dru_gauge = global_registry.gauge(
        "fairness.user.dru",
        "per-user running dominant-resource usage over share")

    _rank(obs, pool, {"a": 3.0, "b": 2.0})
    assert dru_gauge.value({"pool": pool, "user": "b"}) == 2.0

    # b departs: its gauge labels must be retracted, not left stale
    _rank(obs, pool, {"a": 3.0})
    assert dru_gauge.value({"pool": pool, "user": "b"}) == 0.0
    assert obs._exported_users[pool] == {"a"}

    # over-cap population keeps the top users by DRU, counts the rest
    _rank(obs, pool, {"a": 3.0, "b": 2.0, "c": 1.0, "d": 0.5})
    body = obs.snapshot()["pools"][pool]
    assert set(body["trajectories"]) == {"a", "b"}
    assert body["trajectories_truncated"] == 2
    assert dru_gauge.value({"pool": pool, "user": "c"}) == 0.0


def test_rollup_user_overflow_collapses_to_other():
    obs = FairnessObservatory(FairnessConfig(max_rollup_users=3))
    for i in range(6):
        entry = _ledger_entry(i)
        entry["victims"][0]["user"] = f"victim{i}"
        obs.record_decisions("default", [entry])
    by_user = obs.snapshot()["pools"]["default"]["rollups"]["by_user"]
    assert len(by_user) <= 4                    # cap + the "(other)" slot
    assert "(other)" in by_user
    assert by_user["(other)"]["victim_tasks"] >= 1


def test_fragmentation_groups_freed_capacity_by_block():
    obs = FairnessObservatory()
    for i in range(6):                           # blocks 0, 1, 2, 0, 1, 2
        obs.record_decisions("default", [_ledger_entry(i, 100.0 + i)])
    frag = obs.snapshot()["pools"]["default"]["fragmentation"]
    assert frag["decisions"] == 6 and frag["blocks"] == 3
    # block 2 freed the most: 102 + 105 of 615 MB
    assert frag["contiguous_share"] == round(207.0 / 615.0, 4)


def test_sustained_jain_drop_raises_drift_and_clears():
    """The drift rule of tests/test_fairness.py:227, read from the
    observatory's own verdict (the REST health merge is not ported)."""
    obs = FairnessObservatory()
    pool = "port-driftpool"
    even = {"a": 1.0, "b": 1.0, "c": 1.0, "d": 1.0}
    skew = {"a": 4.0, "b": 0.1, "c": 0.1, "d": 0.1}
    for _ in range(20):
        _rank(obs, pool, even)
    assert obs.health_degradations() == []
    for _ in range(8):                     # fill the recent window low
        _rank(obs, pool, skew)
    [deg] = obs.health_degradations()
    assert deg["reason"] == FAIRNESS_DRIFT and deg["pool"] == pool
    assert deg["recent"] < deg["baseline"]
    assert obs.health_checks()[pool]["jain_index"] < 0.5
    for _ in range(8):
        _rank(obs, pool, even)
    assert obs.health_degradations() == []
    assert obs._drift_active is False


def _feed(P):
    """One sequence through a package's observatory: ranks, decisions and a
    mea-culpa kill, across two pools."""
    obs = P.fair.FairnessObservatory(P.fair.FairnessConfig(
        ledger_capacity=5, max_rollup_users=4))
    for i in range(7):
        _rank(obs, "a", {"hog": 3.0 + i, "u1": 0.5, "u2": 0.25 * i}, P)
        entry = _ledger_entry(i, 512.0 * (i + 1))
        entry["victims"][0]["user"] = f"v{i % 5}"
        obs.record_decisions("a" if i % 2 else "b", [entry])
    obs.note_kill("a", "u1", "t-x", 12.5, reason="node-removed")
    return obs.snapshot(ledger_limit=50)


def test_snapshot_equals_reference_on_the_same_sequence():
    assert _feed(PORT) == _feed(REF)


# ------------------------------------------------------------ the drill


def _drill(P):
    """tests/test_fairness.py `_preemption_rig`, fixed uuids: a finite
    default share, a hog filling both hosts, then a starved user's job
    that no longer fits — the rebalance cycle must transact a victim."""
    e = P.ent
    clock = FakeClock()
    store = P.store.JobStore(clock=clock)
    store.set_pool(e.Pool(name="default"))
    cluster = P.mock.MockCluster(
        "m", [P.mock.MockHost(node_id=f"h{i}", hostname=f"h{i}", mem=4000,
                              cpus=8) for i in range(2)], clock=clock)
    sched_kw = dict(P.kw)
    sched_kw["config"] = P.core.SchedulerConfig(use_columnar_index=False)
    scheduler = P.core.Scheduler(store, [cluster], **sched_kw)
    pool = store.pools["default"]
    store.set_share(e.Share(user=e.DEFAULT_USER, pool="default",
                            resources=e.Resources(mem=500, cpus=4)))

    def job(uuid, user, mem, cpus):
        return e.Job(uuid=uuid, user=user, pool="default", command="true",
                     resources=e.Resources(mem=mem, cpus=cpus))

    store.submit_jobs([job(f"hog-{i}", "hog", 1600, 2) for i in range(4)])
    scheduler.rank_cycle(pool)
    scheduler.match_cycle(pool)
    clock.advance(30_000)  # victims accrue runtime -> wasted_s > 0
    store.submit_jobs([job("starved-0", "starved", 1000, 1)])
    scheduler.rank_cycle(pool)
    decisions = scheduler.rebalance_cycle(pool)
    return store, scheduler, decisions


def test_rebalance_drill_lands_the_reference_ledger_and_rollups():
    ref_store_, ref_sched, ref_decisions = _drill(REF)
    store, scheduler, decisions = _drill(PORT)
    assert any(d.task_ids for d in decisions), "drill must preempt"
    assert [(d.job.uuid, d.hostname, d.task_ids) for d in decisions] == \
        [(d.job.uuid, d.hostname, d.task_ids) for d in ref_decisions]
    body = scheduler.fairness.snapshot()["pools"]["default"]
    want = ref_sched.fairness.snapshot()["pools"]["default"]
    for key in ("ledger", "rollups", "fragmentation", "trajectories",
                "jain_index"):
        assert body[key] == want[key], key
    entry = body["ledger"][-1]
    assert entry["preemptor_user"] == "starved"
    assert entry["kind"] == "fairness"
    for victim in entry["victims"]:
        assert victim["user"] == "hog"
        assert victim["dru"] > 1.0          # hog was far over share
        assert victim["wasted_s"] == 30.0   # clock advanced 30s post-match
    rollups = body["rollups"]
    assert rollups["tasks_preempted"] >= 1
    assert rollups["wasted_s"]["fairness"] >= 30.0
    assert rollups["by_user"]["starved"]["preemptions_initiated"] >= 1
    assert body["trajectories"]["hog"]["dru"] > 1.0
    # the victim instance really died with the rebalancer reason, and
    # victim_detail joins the ledger for it
    tid = entry["victims"][0]["task_id"]
    assert store.instances[tid].status == port_ent.InstanceStatus.FAILED
    detail = scheduler.fairness.victim_detail(tid)
    assert detail["preemptor_user"] == "starved"
    assert detail["runtime_lost_s"] == 30.0
    assert scheduler.metrics["rebalance.default.preempted"] == \
        len(entry["victims"])
    assert global_registry.counter(
        "rebalance.preempted",
        "tasks preempted by the rebalancer per pool").value(
        {"pool": "default"}) >= len(entry["victims"])


@pytest.mark.parametrize("P", [REF, PORT], ids=["reference", "port"])
def test_non_rebalancer_mea_culpa_kill_lands_in_mea_culpa_bucket(P):
    e = P.ent
    clock = FakeClock()
    store = P.store.JobStore(clock=clock)
    store.set_pool(e.Pool(name="default"))
    cluster = P.mock.MockCluster(
        "m", [P.mock.MockHost(node_id="h0", hostname="h0", mem=4000,
                              cpus=8)], clock=clock)
    scheduler = P.core.Scheduler(store, [cluster], **P.kw)
    pool = store.pools["default"]
    store.submit_jobs([e.Job(uuid="unlucky-0", user="unlucky",
                             pool="default", command="true")])
    scheduler.rank_cycle(pool)
    scheduler.match_cycle(pool)
    [tid] = [i.task_id for i in store.job_instances("unlucky-0")]
    clock.advance(12_000)
    store.update_instance_state(tid, e.InstanceStatus.FAILED, "node-removed")
    body = scheduler.fairness.snapshot()["pools"]["default"]
    assert body["rollups"]["wasted_s"]["mea_culpa"] == 12.0
    assert body["rollups"]["wasted_s"]["fairness"] == 0.0
    assert body["ledger"] == []   # no preemptor to attribute


def _recovery_store(P):
    e = P.ent
    clock = FakeClock()
    store = P.store.JobStore(clock=clock)
    store.set_pool(e.Pool(name="default"))
    store.submit_jobs([e.Job(uuid="j1", user="victim", pool="default"),
                       e.Job(uuid="j2", user="unlucky", pool="default")])
    for uuid, tid, host in (("j1", "t1", "h1"), ("j2", "t2", "h2")):
        store.create_instance(uuid, tid, hostname=host, compute_cluster="c")
        store.update_instance_state(tid, e.InstanceStatus.RUNNING)
    clock.advance(45_000)
    store.update_instance_state("t1", e.InstanceStatus.FAILED, 1002)
    clock.advance(15_000)
    store.update_instance_state("t2", e.InstanceStatus.FAILED,
                                "node-removed")
    return store


def test_rollups_recover_from_the_store_as_the_reference():
    """tests/test_fairness.py:321 without the journal (the port has no
    persistence layer): recover() replays the store's terminal instances."""
    got = FairnessObservatory()
    assert got.recover(_recovery_store(PORT)) == 2
    want = ref_fair.FairnessObservatory()
    assert want.recover(_recovery_store(REF)) == 2
    rollups = got.snapshot()["pools"]["default"]["rollups"]
    assert rollups == want.snapshot()["pools"]["default"]["rollups"]
    # rebalancer preemption -> fairness bucket; node loss -> mea-culpa
    assert rollups["tasks_preempted"] == 1
    assert rollups["wasted_s"]["fairness"] == 45.0
    assert rollups["wasted_s"]["mea_culpa"] == 60.0
    assert rollups["by_user"]["victim"]["victim_tasks"] == 1
    assert rollups["by_user"]["unlucky"]["victim_wasted_s"] == 60.0
