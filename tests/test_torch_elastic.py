"""The elastic capacity plane of `cook_tpu_torch` against `cook_tpu` on the
CPU: the ports of tests/test_elastic.py's cases (all but the three k8s
scale cases, which wait for the k8s backend), each run on both packages
(`ref` / `port`) with the reference's assertions, and their decisions
compared:

- the solve (`ops/elastic.py`): weighted demand and the plan against the
  numpy oracles and the JAX functions on the same numpy inputs, amounts
  within rtol 1e-4, atol 1e-2 (shortage atol 1e-1: the tolerances of
  tests/test_elastic.py:71, :83-85), the plan's invariants, padded pools,
  a seeded fuzz (P 2..8 padded to 8, live loans) with identical
  `(kind, from, to)` move sets after MIN_MOVE, and the `holds_borrowed`
  pin: a full reclaim returns the loan bit for bit and lets the borrower
  lend, one just short of it does not, alike in all three;
- the durable ledger through the port's `txn/` and `models/persistence`
  (clamp, net, validation, idempotency, journal and snapshot replay,
  racing pool moves);
- the mock cluster's `scale` (the `elastic@{pool}` host, withheld
  capacity, the draining of a busy elastic host);
- the planner and the scheduler (loans and their record, the single-pool
  no-op, bucket padding with no recompile storm, reclaim before
  preemption across a failover, the reclaim replay after a second
  failover) and the simulator A/B (run traces equal the reference's);
- the reference's two REST cases as checks on the recorder's
  `records_json`, the ledger dump and the port's metrics registry;
- the four elastic cases of tests/test_resident_mirrors.py (:179-245)."""
import json
import threading
import types
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cook_tpu import txn as ref_txn
from cook_tpu import elastic as ref_elastic
from cook_tpu.cluster import base as ref_base
from cook_tpu.cluster import mock as ref_mock
from cook_tpu.models import entities as ref_ent
from cook_tpu.models import persistence as ref_persist
from cook_tpu.models import store as ref_store
from cook_tpu.obs import data_plane as ref_dp
from cook_tpu.obs import telemetry as ref_tel
from cook_tpu.ops import common as ref_common
from cook_tpu.ops import cpu_reference as ref_cpu
from cook_tpu.ops import elastic as ref_ops
from cook_tpu.scheduler import core as ref_core
from cook_tpu.scheduler import rebalancer as ref_rb
from cook_tpu.sim import loadgen as ref_loadgen
from cook_tpu.sim import simulator as ref_sim
from cook_tpu.utils import metrics as ref_metrics
from cook_tpu_torch import elastic as port_elastic
from cook_tpu_torch import txn as port_txn
from cook_tpu_torch.cluster import base as port_base
from cook_tpu_torch.cluster import mock as port_mock
from cook_tpu_torch.elastic import planner as port_planner
from cook_tpu_torch.models import entities as port_ent
from cook_tpu_torch.models import persistence as port_persist
from cook_tpu_torch.models import store as port_store
from cook_tpu_torch.obs import data_plane as port_dp
from cook_tpu_torch.obs import telemetry as port_tel
from cook_tpu_torch.ops import cpu_reference as port_cpu
from cook_tpu_torch.ops import elastic as port_ops
from cook_tpu_torch.scheduler import core as port_core
from cook_tpu_torch.scheduler import rebalancer as port_rb
from cook_tpu_torch.sim import loadgen as port_loadgen
from cook_tpu_torch.sim import simulator as port_sim
from cook_tpu_torch.utils import metrics as port_metrics
from tests.conftest import FakeClock

# one intra-op thread: the suite runs several pytest-xdist workers side
# by side, and idle OpenMP threads spinning in each would crowd them
torch.set_num_threads(1)

REF = SimpleNamespace(name="ref", ent=ref_ent, store=ref_store,
                      mock=ref_mock, base=ref_base, core=ref_core,
                      rb=ref_rb, persist=ref_persist, txn=ref_txn,
                      elastic=ref_elastic, tel=ref_tel, dp=ref_dp,
                      sim=ref_sim, loadgen=ref_loadgen,
                      metrics=ref_metrics, kw={})
PORT = SimpleNamespace(name="port", ent=port_ent, store=port_store,
                       mock=port_mock, base=port_base, core=port_core,
                       rb=port_rb, persist=port_persist, txn=port_txn,
                       elastic=port_elastic, tel=port_tel, dp=port_dp,
                       sim=port_sim, loadgen=port_loadgen,
                       metrics=port_metrics, kw={"device": "cpu"})
PKGS = pytest.mark.parametrize("P", [REF, PORT], ids=["ref", "port"])

RTOL, ATOL, SHORT_ATOL = 1e-4, 1e-2, 1e-1
MIN_MOVE = port_planner.MIN_MOVE
DIMS = ("mem", "cpus", "gpus")


def make_job(P, user="alice", pool="default", mem=100.0, cpus=1.0,
             gpus=0.0, uuid=None):
    e = P.ent
    return e.Job(uuid=uuid or e.new_uuid(), user=user, pool=pool,
                 priority=50, max_retries=1,
                 resources=e.Resources(mem=mem, cpus=cpus, gpus=gpus),
                 command="true")


def same_moves(a, b):
    """Move lists equal: the same (kind, from, to) in the same order,
    amounts within the solve's tolerance."""
    assert [(m["kind"], m["from"], m["to"]) for m in a] \
        == [(m["kind"], m["from"], m["to"]) for m in b]
    for x, y in zip(a, b):
        for dim in DIMS:
            assert x[dim] == pytest.approx(y[dim], rel=RTOL, abs=ATOL)


def same_ledger(a, b):
    """Encoded ledgers equal: the same rows, amounts within tolerance."""
    assert [(r["from"], r["to"]) for r in a] == [(r["from"], r["to"])
                                                 for r in b]
    for x, y in zip(a, b):
        for dim in DIMS:
            assert x[dim] == pytest.approx(y[dim], rel=RTOL, abs=ATOL)


# ------------------------------------------------------------ kernel parity


def ref_plan(demand, supply, outstanding, pool_valid, headroom):
    return ref_common.fetch_result(ref_ops.solve_capacity_plan(
        ref_ops.ElasticProblem(jnp.asarray(demand), jnp.asarray(supply),
                               jnp.asarray(outstanding),
                               jnp.asarray(pool_valid)),
        jnp.float32(headroom)))


def port_plan(demand, supply, outstanding, pool_valid, headroom):
    plan = port_ops.solve_capacity_plan(
        port_ops.ElasticProblem(*(torch.as_tensor(a) for a in (
            demand, supply, outstanding, pool_valid))),
        headroom)
    return type(plan)(*(t.numpy() for t in plan))


def _rand_problem(p=8, live=5, seed=0):
    rng = np.random.default_rng(seed)
    demand = rng.uniform(0, 100_000, (p, 3)).astype(np.float32)
    supply = rng.uniform(0, 100_000, (p, 3)).astype(np.float32)
    outstanding = np.zeros((p, p, 3), np.float32)
    outstanding[0, 1] = (5000.0, 8.0, 0.0)
    outstanding[2, 3] = (100.0, 1.0, 0.0)
    pool_valid = np.arange(p) < live
    return demand, supply, outstanding, pool_valid


def close_plans(got, want):
    np.testing.assert_allclose(got.reclaim, want[0], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.loan, want[1], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.shortage, want[2], rtol=RTOL,
                               atol=SHORT_ATOL)


def move_set(plan, n_pools):
    """{(kind, from, to)} of the moves `_extract_moves` would commit: any
    dimension at or over its MIN_MOVE."""
    out = set()
    for kind, matrix in (("reclaim", plan.reclaim), ("loan", plan.loan)):
        for li in range(n_pools):
            for bi in range(n_pools):
                if li != bi and any(matrix[li, bi, d] >= MIN_MOVE[dim]
                                    for d, dim in enumerate(DIMS)):
                    out.add((kind, li, bi))
    return out


@pytest.mark.parametrize("half_life", [16.0, 1.0, 0.5])
def test_weighted_demand_matches_cpu_reference_and_jax(half_life):
    rng = np.random.default_rng(1)
    res = rng.uniform(0, 4000, (6, 32, 3)).astype(np.float32)
    valid = rng.uniform(size=(6, 32)) < 0.5
    want = port_cpu.ref_weighted_demand(res, valid, half_life)
    np.testing.assert_array_equal(
        want, ref_cpu.ref_weighted_demand(res, valid, half_life))
    jax_out = ref_common.fetch_result(ref_ops.weighted_demand(
        jnp.asarray(res), jnp.asarray(valid), jnp.float32(half_life)))
    for h in (half_life, torch.tensor(half_life)):
        got = port_ops.weighted_demand(torch.as_tensor(res),
                                       torch.as_tensor(valid), h).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got, jax_out, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_capacity_plan_matches_cpu_reference_and_jax(seed):
    args = _rand_problem(seed=seed)
    want = port_cpu.ref_capacity_plan(*args, 0.1)
    got = port_plan(*args, 0.1)
    close_plans(got, want)
    jax_plan = ref_plan(*args, 0.1)
    close_plans(got, tuple(jax_plan))
    assert move_set(got, 5) == move_set(jax_plan, 5)
    # a 0-d tensor headroom gives the float's plan, bit for bit
    again = port_plan(*args, torch.tensor(0.1))
    for a, b in zip(got, again):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("P", ["ref", "port"])
def test_plan_invariants_reclaim_first_and_headroom(P):
    p = 8
    demand = np.zeros((p, 3), np.float32)
    supply = np.zeros((p, 3), np.float32)
    outstanding = np.zeros((p, p, 3), np.float32)
    # pool 0 loaned 40 cpus to pool 1 and now needs 30; pool 1 has 50 free
    demand[0] = (0, 30, 0)
    supply[1] = (0, 50, 0)
    # pool 2 idles with surplus, pool 3 is short — a fresh loan case
    supply[2] = (0, 100, 0)
    demand[3] = (0, 20, 0)
    outstanding[0, 1] = (0, 40, 0)
    solve = ref_plan if P == "ref" else port_plan
    plan = solve(demand, supply, outstanding, np.ones(p, bool), 0.1)
    assert plan.reclaim[0, 1, 1] == pytest.approx(30.0, abs=1e-3)
    assert plan.loan[:, 0, 1].sum() == pytest.approx(0.0, abs=1e-3)
    assert plan.loan[2, 3, 1] == pytest.approx(20.0, abs=1e-3)
    assert plan.loan[2].sum() <= supply[2, 1] * 0.9 + 1e-3
    # pool 1 still holds borrowed capacity: it must not re-loan it
    assert plan.loan[1].sum() == pytest.approx(0.0, abs=1e-3)


@pytest.mark.parametrize("P", ["ref", "port"])
def test_plan_ignores_padded_pools(P):
    solve = ref_plan if P == "ref" else port_plan
    plan = solve(*_rand_problem(live=3), 0.0)
    assert plan.loan[3:].sum() == 0.0 and plan.loan[:, 3:].sum() == 0.0
    assert plan.reclaim[3:].sum() == 0.0


def _holds_borrowed(outstanding, reclaim):
    return (outstanding - reclaim).sum(axis=(0, 2)) > 0


@pytest.mark.parametrize("mem_shortage", [8000.0, 5000.0, 4999.0],
                         ids=["over", "exact", "just-short"])
def test_holds_borrowed_full_reclaim_vs_just_short(mem_shortage):
    """Pool 0 loaned (5000 MB, 8 cpus) to pool 1 and is short again;
    pool 1 has room to return it all, and pool 2 is short.  A shortage
    covering the loan (over it, or exactly it) reclaims it whole, bit
    for bit, so pool 1 holds nothing borrowed and lends to pool 2; one
    MB short of it leaves a residual, and pool 1 may not lend.  The JAX
    function, the numpy oracle and the port agree."""
    p = 8
    demand = np.zeros((p, 3), np.float32)
    supply = np.zeros((p, 3), np.float32)
    outstanding = np.zeros((p, p, 3), np.float32)
    outstanding[0, 1] = (5000.0, 8.0, 0.0)
    supply[0] = (1000.0, 2.0, 0.0)
    demand[0] = (1000.0 + mem_shortage, 10.0, 0.0)
    supply[1] = (40_000.0, 40.0, 0.0)
    demand[2] = (6000.0, 6.0, 0.0)
    valid = np.arange(p) < 3
    full = mem_shortage >= 5000.0
    jax_plan = ref_plan(demand, supply, outstanding, valid, 0.1)
    oracle = port_cpu.ref_capacity_plan(demand, supply, outstanding, valid,
                                        0.1)
    got = port_plan(demand, supply, outstanding, valid, 0.1)
    held = port_ops.holds_borrowed(
        port_ops.ElasticProblem(*(torch.as_tensor(a) for a in (
            demand, supply, outstanding, valid))),
        port_ops.ElasticPlan(*(torch.as_tensor(a) for a in got))).numpy()
    assert bool(held[1]) is (not full)
    assert bool(_holds_borrowed(outstanding, jax_plan.reclaim)[1]) \
        is (not full)
    assert bool(_holds_borrowed(outstanding, oracle[0])[1]) is (not full)
    if full:
        np.testing.assert_array_equal(got.reclaim[0, 1], outstanding[0, 1])
        np.testing.assert_array_equal(jax_plan.reclaim[0, 1],
                                      outstanding[0, 1])
        assert got.loan[1, 2].sum() > 0 and jax_plan.loan[1, 2].sum() > 0
    else:
        assert got.reclaim[0, 1, 0] < outstanding[0, 1, 0]
        assert got.loan[1].sum() == 0.0 and jax_plan.loan[1].sum() == 0.0
    close_plans(got, oracle)
    close_plans(got, tuple(jax_plan))
    assert move_set(got, 3) == move_set(jax_plan, 3)


@pytest.mark.parametrize("seed", range(12))
def test_capacity_plan_fuzz_against_jax(seed):
    """P live pools in 2..8 padded to 8, live loans among them (some
    lenders short enough to reclaim whole, some not), random headroom:
    amounts within tolerance, identical move sets."""
    rng = np.random.default_rng(100 + seed)
    p = 8
    live = int(rng.integers(2, 9))
    scale = np.array([64_000.0, 64.0, 8.0], np.float32)
    demand = (rng.uniform(0, 1, (p, 3)) * scale
              * (rng.uniform(size=(p, 1)) < 0.6)).astype(np.float32)
    supply = (rng.uniform(0, 1, (p, 3)) * scale).astype(np.float32)
    outstanding = np.zeros((p, p, 3), np.float32)
    for _ in range(int(rng.integers(1, 6))):
        lender, borrower = rng.choice(live, 2, replace=False)
        outstanding[lender, borrower] = np.round(
            rng.uniform(0, 0.5, 3) * scale)
    # integer amounts: sums are exact in any order
    demand, supply = np.round(demand), np.round(supply)
    valid = np.arange(p) < live
    headroom = float(rng.choice([0.0, 0.1, 0.25]))
    jax_plan = ref_plan(demand, supply, outstanding, valid, headroom)
    got = port_plan(demand, supply, outstanding, valid, headroom)
    close_plans(got, tuple(jax_plan))
    close_plans(got, port_cpu.ref_capacity_plan(demand, supply, outstanding,
                                                valid, headroom))
    assert move_set(got, live) == move_set(jax_plan, live)
    np.testing.assert_array_equal(
        _holds_borrowed(outstanding, got.reclaim),
        _holds_borrowed(outstanding, jax_plan.reclaim))


def test_elastic_ops_keep_the_device_and_make_no_nan():
    """Everything stays on the inputs' device and no guarded division
    makes an inf or nan (all-zero demand, supply and loans)."""
    z = torch.zeros
    problem = port_ops.ElasticProblem(z(8, 3), z(8, 3), z(8, 8, 3),
                                      torch.ones(8, dtype=torch.bool))
    plan = port_ops.solve_capacity_plan(problem, 0.1)
    for t in plan:
        assert t.device.type == "cpu" and torch.isfinite(t).all()
        assert not t.any()
    d = port_ops.weighted_demand(z(8, 64, 3),
                                 torch.zeros(8, 64, dtype=torch.bool), 0.0)
    assert torch.isfinite(d).all() and d.shape == (8, 3)


# ------------------------------------------------------- ledger + txn + io


def _ledger_store(P, clock=None):
    store = P.store.JobStore(clock=clock or FakeClock())
    store.set_pool(P.ent.Pool(name="lender"))
    store.set_pool(P.ent.Pool(name="borrower"))
    return store


@PKGS
def test_ledger_apply_clamp_and_net(P):
    store = _ledger_store(P)
    txn = P.txn.TransactionLog(store)
    txn.commit("pool/capacity-delta", {"moves": [
        {"kind": "loan", "from": "lender", "to": "borrower",
         "mem": 1000.0, "cpus": 8.0, "gpus": 0.0}]})
    assert store.net_capacity_adjustment("borrower")["cpus"] == 8.0
    assert store.net_capacity_adjustment("lender")["cpus"] == -8.0
    # reclaim clamps at outstanding: asking 100 back returns only 8
    txn.commit("pool/capacity-delta", {"moves": [
        {"kind": "reclaim", "from": "lender", "to": "borrower",
         "mem": 9999.0, "cpus": 100.0, "gpus": 0.0}]})
    assert store.capacity_ledger == {}
    assert store.net_capacity_adjustment("lender")["cpus"] == 0.0


@PKGS
def test_capacity_delta_validation_and_idempotency(P):
    store = _ledger_store(P)
    txn = P.txn.TransactionLog(store)
    vetoed = P.store.TransactionVetoed
    with pytest.raises(vetoed):
        txn.commit("pool/capacity-delta", {"moves": [
            {"kind": "loan", "from": "lender", "to": "nope", "cpus": 1.0}]})
    with pytest.raises(vetoed):
        txn.commit("pool/capacity-delta", {"moves": [
            {"kind": "loan", "from": "lender", "to": "lender", "cpus": 1.0}]})
    with pytest.raises(vetoed):
        txn.commit("pool/capacity-delta", {"moves": [
            {"kind": "loan", "from": "lender", "to": "borrower",
             "cpus": -1.0}]})
    with pytest.raises(vetoed):
        txn.commit("pool/capacity-delta", {"moves": [
            {"kind": "gift", "from": "lender", "to": "borrower",
             "cpus": 1.0}]})
    out1 = txn.commit("pool/capacity-delta", {"moves": [
        {"kind": "loan", "from": "lender", "to": "borrower", "cpus": 4.0}]},
        txn_id="cap-1")
    out2 = txn.commit("pool/capacity-delta", {"moves": [
        {"kind": "loan", "from": "lender", "to": "borrower", "cpus": 4.0}]},
        txn_id="cap-1")
    assert out2.duplicate and out2.result == out1.result
    # the duplicate must NOT have double-applied
    assert store.net_capacity_adjustment("borrower")["cpus"] == 4.0
    assert sorted(P.txn.OPS) == sorted(ref_txn.OPS)


@PKGS
def test_ledger_survives_snapshot_and_journal_replay(P, tmp_path):
    store = _ledger_store(P)
    journal = P.persist.attach_journal(store,
                                       str(tmp_path / "journal.jsonl"))
    txn = P.txn.TransactionLog(store, journal=journal)
    txn.commit("pool/capacity-delta", {"moves": [
        {"kind": "loan", "from": "lender", "to": "borrower",
         "mem": 2000.0, "cpus": 16.0, "gpus": 1.0}]})
    txn.commit("pool/capacity-delta", {"moves": [
        {"kind": "reclaim", "from": "lender", "to": "borrower",
         "mem": 500.0, "cpus": 4.0, "gpus": 0.0}]})
    journal.close()
    recovered = P.persist.recover(str(tmp_path))
    assert recovered.capacity_ledger == store.capacity_ledger
    assert recovered.capacity_ledger[("lender", "borrower")]["cpus"] == 12.0
    P.persist.snapshot(store, str(tmp_path / "snapshot.json"))
    recovered2 = P.persist.recover(str(tmp_path))
    assert recovered2.capacity_ledger == store.capacity_ledger
    txn_ids = list(recovered.txn_results)
    replay = P.txn.TransactionLog(recovered).commit(
        "pool/capacity-delta", {"moves": []}, txn_id=txn_ids[0])
    assert replay.duplicate


@PKGS
def test_capacity_deltas_racing_pool_moves_stay_consistent(P):
    """Loans/reclaims and job pool-moves hammer the same commit pipeline
    concurrently; the ledger must stay non-negative and every job must
    land in exactly one pool."""
    store = _ledger_store(P)
    txn = P.txn.TransactionLog(store)
    jobs = [make_job(P, user="u", pool="borrower", mem=10, cpus=1)
            for _ in range(40)]
    store.submit_jobs(jobs)
    errors = []

    def capacity_churn():
        try:
            for _ in range(50):
                txn.commit("pool/capacity-delta", {"moves": [
                    {"kind": "loan", "from": "lender", "to": "borrower",
                     "mem": 100.0, "cpus": 1.0, "gpus": 0.0}]})
                txn.commit("pool/capacity-delta", {"moves": [
                    {"kind": "reclaim", "from": "lender", "to": "borrower",
                     "mem": 100.0, "cpus": 1.0, "gpus": 0.0}]})
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    def mover():
        try:
            for job in jobs:
                txn.commit("job/pool-move",
                           {"uuid": job.uuid, "pool": "lender"})
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=capacity_churn),
               threading.Thread(target=mover)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert not errors
    assert store.capacity_ledger == {}
    for job in jobs:
        assert store.jobs[job.uuid].pool == "lender"
    replayed = P.store.JobStore()
    replayed.set_pool(P.ent.Pool(name="lender"))
    replayed.set_pool(P.ent.Pool(name="borrower"))
    events = [json.loads(e.to_json()) for e in store.snapshot_events()]
    P.persist.apply_journal(replayed, events)
    assert replayed.capacity_ledger == store.capacity_ledger


# ----------------------------------------------------------- cluster scale


def _offers(cluster, pool):
    return {o.node_id: (o.mem, o.cpus, o.gpus)
            for o in cluster.pending_offers(pool)}


def _scale_withhold(P):
    clock = FakeClock()
    cluster = P.mock.MockCluster("m", [
        P.mock.MockHost(node_id="l0", hostname="l0", mem=16000, cpus=16,
                        pool="lender"),
        P.mock.MockHost(node_id="b0", hostname="b0", mem=4000, cpus=4,
                        pool="borrower"),
    ], clock=clock)
    assert cluster.supports_scale()
    cluster.scale("borrower", {"mem": 8000.0, "cpus": 8.0, "gpus": 0.0})
    cluster.scale("lender", {"mem": -8000.0, "cpus": -8.0, "gpus": 0.0})
    seen = [_offers(cluster, "borrower"), _offers(cluster, "lender")]
    assert seen[0]["elastic@borrower"][1] == 8.0
    assert seen[1]["l0"][:2] == (8000.0, 8.0)
    cluster.scale("borrower", {"mem": 0.0, "cpus": 0.0, "gpus": 0.0})
    cluster.scale("lender", {"mem": 0.0, "cpus": 0.0, "gpus": 0.0})
    assert "elastic@borrower" not in cluster.hosts
    seen.append(_offers(cluster, "lender"))
    assert seen[-1]["l0"][1] == 16.0
    return seen


def test_mock_scale_materializes_and_withholds_capacity():
    assert _scale_withhold(PORT) == _scale_withhold(REF)


def _scale_drain(P):
    clock = FakeClock()
    cluster = P.mock.MockCluster("m", [], clock=clock)
    cluster.scale("p", {"mem": 8000.0, "cpus": 8.0, "gpus": 0.0})
    cluster.launch_tasks("p", [P.base.TaskSpec(
        task_id="t1", job_uuid="j1", user="u", command="c", mem=1000,
        cpus=2, gpus=0, node_id="elastic@p", hostname="elastic@p")])
    cluster.scale("p", {"mem": 0.0, "cpus": 0.0, "gpus": 0.0})
    assert "elastic@p" in cluster.hosts
    drained = _offers(cluster, "p")
    assert drained["elastic@p"][1] == 0.0
    cluster.kill_task("t1")
    cluster.scale("p", {"mem": 0.0, "cpus": 0.0, "gpus": 0.0})
    assert "elastic@p" not in cluster.hosts
    return drained


def test_mock_scale_drains_busy_elastic_host():
    assert _scale_drain(PORT) == _scale_drain(REF)


def test_inelastic_backend_scale_is_a_no_op():
    class Inelastic(port_base.ComputeCluster):
        def pending_offers(self, pool):
            return []

        def launch_tasks(self, pool, specs):
            pass

        def kill_task(self, task_id):
            pass

    cluster = Inelastic("x")
    assert not cluster.supports_scale()
    assert cluster.scale("p", {"cpus": 4.0}) == {}


# ------------------------------------------------- planner + observability


def _two_pool_scheduler(P, clock=None, data_dir=None, elastic=True,
                        borrower_hosts=0):
    clock = clock or FakeClock()
    store = P.store.JobStore(clock=clock)
    journal = None
    if data_dir is not None:
        journal = P.persist.attach_journal(
            store, str(data_dir / "journal.jsonl"))
    store.set_pool(P.ent.Pool(name="lender"))
    store.set_pool(P.ent.Pool(name="borrower"))
    hosts = [P.mock.MockHost(node_id="l0", hostname="l0", mem=16000,
                             cpus=16, pool="lender")]
    hosts += [P.mock.MockHost(node_id=f"b{i}", hostname=f"b{i}", mem=4000,
                              cpus=4, pool="borrower")
              for i in range(borrower_hosts)]
    cluster = P.mock.MockCluster("m", hosts, clock=clock)
    txn = P.txn.TransactionLog(store, journal=journal)
    scheduler = P.core.Scheduler(
        store, [cluster],
        P.core.SchedulerConfig(elastic=P.elastic.ElasticParams(
            enabled=elastic)),
        txn=txn, **P.kw)
    return store, cluster, scheduler, txn, journal


def _loan_case(P):
    store, cluster, scheduler, txn, _ = _two_pool_scheduler(P)
    for i in range(6):
        store.submit_jobs([make_job(P, user="alice", pool="borrower",
                                    mem=2000, cpus=2, uuid=f"j{i}")])
    record = scheduler.elastic_cycle()
    assert record is not None and record.moves
    loan = record.moves[0]
    assert loan["kind"] == "loan" and loan["from"] == "lender" \
        and loan["to"] == "borrower"
    assert store.capacity_ledger[("lender", "borrower")]["cpus"] > 0
    assert record.txn_id in store.txn_results
    offers = {o.node_id: o for o in cluster.pending_offers("borrower")}
    assert "elastic@borrower" in offers
    lender_spare = sum(o.cpus for o in cluster.pending_offers("lender"))
    assert lender_spare < 16.0
    plans = scheduler.elastic.recorder.records_json()
    assert plans and plans[-1]["txn_id"] == record.txn_id
    borrower = store.pools["borrower"]
    scheduler.rank_cycle(borrower)
    outcome = scheduler.match_cycle(borrower)
    cycle = scheduler.recorder.records_json(pool="borrower")[-1]
    assert cycle["elastic_plan"] == record.plan_id
    assert cycle["pool_capacity"]["hosts"] >= 1
    assert cycle["pool_capacity"]["spare_cpus"] >= 0.0
    return dict(moves=record.moves, demand=record.demand,
                supply=record.supply, unmet=record.unmet,
                shape=record.solve_shape, backend=record.backend,
                ledger=store.encoded_capacity_ledger(),
                placed=sorted((j.uuid, o.hostname)
                              for j, o in outcome.matched),
                capacity=cycle["pool_capacity"],
                lender_spare=lender_spare)


def _same_per_pool(a, b):
    assert sorted(a) == sorted(b)
    for pool in a:
        for dim in DIMS:
            assert a[pool][dim] == pytest.approx(b[pool][dim], rel=RTOL,
                                                 abs=SHORT_ATOL)


def test_planner_loans_idle_capacity_and_records():
    ref, port = _loan_case(REF), _loan_case(PORT)
    same_moves(port.pop("moves"), ref.pop("moves"))
    same_ledger(port.pop("ledger"), ref.pop("ledger"))
    for key in ("demand", "supply", "unmet"):
        _same_per_pool(port.pop(key), ref.pop(key))
    assert port.pop("lender_spare") == pytest.approx(ref.pop("lender_spare"),
                                                     rel=RTOL, abs=ATOL)
    # the elastic host holds the loaned amounts: equal within tolerance
    cap_port, cap_ref = port.pop("capacity"), ref.pop("capacity")
    assert sorted(cap_port) == sorted(cap_ref)
    for key, value in cap_ref.items():
        assert cap_port[key] == pytest.approx(value, rel=RTOL, abs=ATOL)
    assert port == ref


@PKGS
def test_planner_no_op_with_single_pool(P):
    clock = FakeClock()
    store = P.store.JobStore(clock=clock)
    store.set_pool(P.ent.Pool(name="only"))
    cluster = P.mock.MockCluster("m", [P.mock.MockHost(
        node_id="h", hostname="h", mem=1000, cpus=1, pool="only")],
        clock=clock)
    scheduler = P.core.Scheduler(
        store, [cluster], P.core.SchedulerConfig(
            elastic=P.elastic.ElasticParams(enabled=True)), **P.kw)
    assert scheduler.elastic_cycle() is None


def test_disabled_plane_builds_no_planner():
    store = port_store.JobStore(clock=FakeClock())
    scheduler = port_core.Scheduler(store, [], device="cpu")
    assert scheduler.elastic is None and scheduler.elastic_cycle() is None


def _bucket_case(P):
    clock = FakeClock()
    store = P.store.JobStore(clock=clock)
    for i in range(6):
        store.set_pool(P.ent.Pool(name=f"p{i}"))
    cluster = P.mock.MockCluster("m", [
        P.mock.MockHost(node_id=f"h{i}", hostname=f"h{i}", mem=8000,
                        cpus=8, pool=f"p{i}") for i in range(6)],
        clock=clock)
    kw = ({"update_memory_gauges": False} if P is REF else {})
    telemetry = P.tel.DeviceTelemetry(storm_warmup=0, **kw)
    planner = P.elastic.CapacityPlanner(
        store, [cluster], P.txn.TransactionLog(store),
        P.elastic.ElasticParams(enabled=True), telemetry=telemetry,
        **P.kw)
    rng = np.random.default_rng(0)
    plans = []
    for trial in range(24):
        queues = {}
        for i in range(int(rng.integers(2, 7))):
            jobs = [make_job(P, user="u", pool=f"p{i}", mem=100, cpus=1,
                             uuid=f"t{trial}-p{i}-{k}")
                    for k in range(int(rng.integers(1, 50)))]
            queues[f"p{i}"] = types.SimpleNamespace(jobs=jobs)
        record = planner.plan_cycle(queues)
        plans.append((record.solve_shape, record.moves))
    stats = telemetry.observatory.stats().get("elastic_plan", {})
    assert stats.get("programs", 99) == 1
    assert "elastic_plan" not in telemetry.observatory.storming_ops()
    return plans, store.encoded_capacity_ledger()


def test_planner_solves_bucket_padded_no_recompile_storm():
    ref, port = _bucket_case(REF), _bucket_case(PORT)
    assert [s for s, _ in port[0]] == [s for s, _ in ref[0]]
    for (_, a), (_, b) in zip(port[0], ref[0]):
        same_moves(a, b)
    same_ledger(port[1], ref[1])


# ------------------------------------- reclaim-before-preemption + failover


def _pressure_lender(P, store):
    store.set_share(P.ent.Share(user="bob", pool="lender",
                                resources=P.ent.Resources(mem=100.0,
                                                          cpus=1.0)))
    bob = make_job(P, user="bob", pool="lender", mem=8000, cpus=8,
                   uuid="bob")
    store.submit_jobs([bob])
    store.create_instance(bob.uuid, "task-bob", hostname="l0",
                          node_id="l0", compute_cluster="m")
    store.update_instance_state("task-bob", P.ent.InstanceStatus.RUNNING,
                                None)
    alice = make_job(P, user="alice", pool="lender", mem=8000, cpus=8,
                     uuid="alice")
    store.submit_jobs([alice])
    return bob, alice


def _failover_case(P, tmp_path):
    clock = FakeClock()
    store, cluster, scheduler, txn, journal = _two_pool_scheduler(
        P, clock=clock, data_dir=tmp_path)
    for i in range(4):
        store.submit_jobs([make_job(P, user="carol", pool="borrower",
                                    mem=3000, cpus=3, uuid=f"c{i}")])
    record = scheduler.elastic_cycle()
    assert record.moves and store.outstanding_loans_from("lender")
    journal.close()

    store2 = P.persist.recover(str(tmp_path))
    assert store2.capacity_ledger == store.capacity_ledger
    cluster2 = P.mock.MockCluster("m", [P.mock.MockHost(
        node_id="l0", hostname="l0", mem=16000, cpus=16, pool="lender")],
        clock=clock)
    scheduler2 = P.core.Scheduler(
        store2, [cluster2],
        P.core.SchedulerConfig(elastic=P.elastic.ElasticParams(
            enabled=True)),
        txn=P.txn.TransactionLog(store2), **P.kw)
    scheduler2.elastic.reconcile()
    loaned = store2.capacity_ledger[("lender", "borrower")]["cpus"]
    assert sum(o.cpus for o in cluster2.pending_offers("lender")) \
        == pytest.approx(16.0 - loaned)

    bob, alice = _pressure_lender(P, store2)
    lender = store2.pools["lender"]
    scheduler2.rank_cycle(lender)
    scheduler2.match_cycle(lender)
    assert store2.jobs[alice.uuid].state.value == "waiting"

    # CONTROL: the same victim search WITHOUT the reclaimer picks bob
    spare = scheduler2.last_unmatched_offers["lender"]
    queue = scheduler2.pool_queues["lender"]
    control = P.rb.rebalance_pool(store2, lender, queue.jobs, spare,
                                  P.rb.RebalancerParams(), **P.kw)
    assert control and "task-bob" in control[0].task_ids

    decisions = scheduler2.rebalance_cycle(lender)
    assert decisions == []
    assert store2.outstanding_loans_from("lender") == {}
    assert not store2.instances["task-bob"].status.terminal
    assert sum(o.cpus for o in cluster2.pending_offers("lender")) \
        == pytest.approx(16.0)
    plans = scheduler2.elastic.recorder.records_json()
    assert "reclaim-on-demand" in [p["kind"] for p in plans]
    scheduler2.rank_cycle(lender)
    outcome = scheduler2.match_cycle(lender)
    assert any(j.uuid == alice.uuid for j, _ in outcome.matched)
    return dict(loan=record.moves, reclaim=plans[-1]["moves"],
                control=[d.task_ids for d in control],
                placed=sorted((j.uuid, o.hostname)
                              for j, o in outcome.matched),
                loaned=loaned)


def test_reclaim_returns_capacity_before_preemption_across_failover(
        tmp_path):
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    ref = _failover_case(REF, tmp_path / "ref")
    port = _failover_case(PORT, tmp_path / "port")
    for key in ("loan", "reclaim"):
        same_moves(port.pop(key), ref.pop(key))
    assert port.pop("loaned") == pytest.approx(ref.pop("loaned"), rel=RTOL)
    assert port == ref


@PKGS
def test_reclaim_txn_replay_is_consistent_after_second_failover(P,
                                                                tmp_path):
    clock = FakeClock()
    store, cluster, scheduler, txn, journal = _two_pool_scheduler(
        P, clock=clock, data_dir=tmp_path)
    txn.commit("pool/capacity-delta", {"moves": [
        {"kind": "loan", "from": "lender", "to": "borrower",
         "mem": 4000.0, "cpus": 4.0, "gpus": 0.0}]})
    txn.commit("pool/capacity-delta", {"moves": [
        {"kind": "reclaim", "from": "lender", "to": "borrower",
         "mem": 4000.0, "cpus": 4.0, "gpus": 0.0}]}, txn_id="reclaim-1")
    journal.close()
    store2 = P.persist.recover(str(tmp_path))
    assert store2.capacity_ledger == {}
    out = P.txn.TransactionLog(store2).commit(
        "pool/capacity-delta", {"moves": [
            {"kind": "reclaim", "from": "lender", "to": "borrower",
             "mem": 4000.0, "cpus": 4.0, "gpus": 0.0}]},
        txn_id="reclaim-1")
    assert out.duplicate
    assert store2.capacity_ledger == {}


# ------------------------------------------------------------ simulator A/B


def _ab_run(P, elastic_every):
    jobs, hosts = P.loadgen.imbalanced_pool_trace(busy_jobs=24,
                                                  runtime_ms=60_000)
    config = P.sim.SimConfig(
        cycle_ms=30_000, max_cycles=60, elastic_every=elastic_every,
        pools=(("busy", "default"), ("idle", "default")),
        scheduler=P.core.SchedulerConfig(flight_recorder_capacity=64))
    return P.sim.Simulator(jobs, hosts, config, **P.kw).run()


def test_simulator_ab_elastic_lowers_queued_wait():
    """Imbalanced pools: the p50 queued-job wait is lower with the
    planner on than with static pools, on both packages, and the port's
    run traces, plans and ledger equal the reference's."""
    runs = {}
    for P in (REF, PORT):
        static, elastic = _ab_run(P, 0), _ab_run(P, 1)
        p50_static = float(np.percentile(static.queued_wait_ms(), 50))
        p50_elastic = float(np.percentile(elastic.queued_wait_ms(), 50))
        assert p50_elastic < p50_static
        assert any(p["moves"] for p in elastic.elastic_plans)
        assert any(row["from"] == "idle" and row["to"] == "busy"
                   for row in elastic.capacity_ledger)
        assert all("pool_capacity" in r for r in elastic.cycle_records)
        runs[P.name] = (static, elastic)
    for k in range(2):
        assert runs["port"][k].to_csv() == runs["ref"][k].to_csv()
    ref_plans = runs["ref"][1].elastic_plans
    port_plans = runs["port"][1].elastic_plans
    assert [p["kind"] for p in port_plans] == [p["kind"] for p in ref_plans]
    for a, b in zip(port_plans, ref_plans):
        same_moves(a["moves"], b["moves"])
    same_ledger(runs["port"][1].capacity_ledger,
                runs["ref"][1].capacity_ledger)
    assert [r["elastic_plan"] for r in runs["port"][1].cycle_records] \
        == [r["elastic_plan"] for r in runs["ref"][1].cycle_records]


# ------------------------------------------------- the REST cases, no HTTP


def _debug_elastic(P):
    """What the reference's GET /debug/elastic serves, read off the
    planner: enabled, the plans ring, the ledger and the per-pool net."""
    store, cluster, scheduler, txn, _ = _two_pool_scheduler(P)
    for i in range(6):
        store.submit_jobs([make_job(P, user="alice", pool="borrower",
                                    mem=2000, cpus=2, uuid=f"j{i}")])
    record = scheduler.elastic_cycle()
    body = {"enabled": scheduler.config.elastic.enabled,
            "ledger": store.encoded_capacity_ledger(),
            "net": {p: store.net_capacity_adjustment(p)
                    for p in sorted(store.pools)},
            "plans": scheduler.elastic.recorder.records_json()}
    assert body["enabled"] is True
    assert body["ledger"] and body["ledger"][0]["from"] == "lender"
    assert body["net"]["borrower"]["cpus"] > 0
    assert body["net"]["lender"]["cpus"] < 0
    assert body["plans"][-1]["plan"] == record.plan_id
    assert body["plans"][-1]["moves"]
    limited = scheduler.elastic.recorder.records_json(limit=1,
                                                      kind="interval")
    assert len(limited) == 1
    assert scheduler.elastic.recorder.records_json(
        kind="reclaim-on-demand") == []
    return body, scheduler


def test_debug_elastic_records_and_ledger():
    ref, _ = _debug_elastic(REF)
    port, _ = _debug_elastic(PORT)
    same_ledger(port["ledger"], ref["ledger"])
    _same_per_pool(port["net"], ref["net"])
    assert [p["kind"] for p in port["plans"]] \
        == [p["kind"] for p in ref["plans"]]
    same_moves(port["plans"][-1]["moves"], ref["plans"][-1]["moves"])
    keys = set(ref["plans"][-1])
    assert set(port["plans"][-1]) == keys
    assert port["plans"][-1]["solve_shape"] == ref["plans"][-1][
        "solve_shape"]
    assert port["plans"][-1]["backend"] == "xla"


@PKGS
def test_loaned_gauge_and_metrics_exposition(P):
    _debug_elastic(P)
    text = P.metrics.global_registry.render_prometheus()
    assert "cook_elastic_loaned{" in text
    assert 'from="lender"' in text and 'to="borrower"' in text
    assert "cook_elastic_plans" in text
    # the reclaim histogram is registered (TYPE line) even before any
    # reclaim has been observed
    assert "cook_elastic_reclaim_seconds" in text
    gauge = P.metrics.global_registry.gauge("elastic.loaned")
    assert gauge.value({"from": "lender", "to": "borrower",
                        "resource": "cpus"}) > 0


# ----------------------------------- resident mirror (test_resident_mirrors)


def _elastic_rig(P, n_pools=4, queue_len=16):
    store = P.store.JobStore(clock=lambda: 1_000_000)
    for i in range(n_pools):
        store.set_pool(P.ent.Pool(name=f"p{i}"))
    cluster = P.mock.MockCluster("m", [
        P.mock.MockHost(node_id=f"h{i}", hostname=f"h{i}", mem=8000.0,
                        cpus=8.0, pool=f"p{i}") for i in range(n_pools)],
        clock=store.clock)

    def job(pool, k):
        return P.ent.Job(uuid=f"el-{pool}-{k}", user="u", pool=pool,
                         priority=50,
                         resources=P.ent.Resources(mem=100.0 + k, cpus=1.0),
                         command="true")

    # last pool idles: a lender
    queues = {f"p{i}": types.SimpleNamespace(
        jobs=[job(f"p{i}", k) for k in range(queue_len)])
        for i in range(n_pools - 1)}
    return store, cluster, queues, job


def _planner(P, store, cluster, resident):
    return P.elastic.CapacityPlanner(
        store, [cluster], P.txn.TransactionLog(store),
        P.elastic.ElasticParams(enabled=True, resident=resident), **P.kw)


def _fam_h2d(P):
    return P.dp.LEDGER.family_totals().get(
        P.dp.FAM_ELASTIC, {}).get("h2d_bytes", 0)


def _warm_case(P):
    store, cluster, queues, _ = _elastic_rig(P)
    planner = _planner(P, store, cluster, True)
    m0 = _fam_h2d(P)
    assert planner.plan_cycle(queues) is not None
    cold = _fam_h2d(P) - m0
    assert cold > 0
    assert planner._resident.last["reason"] == "cold"
    warms = []
    for _ in range(2):
        m0 = _fam_h2d(P)
        planner.plan_cycle(queues)
        warm = _fam_h2d(P) - m0
        assert planner._resident.last["rebuild"] is False
        assert warm <= 0.1 * cold, (warm, cold)
        warms.append(warm)
    return cold, warms


def test_elastic_warm_plans_cut_h2d_by_90_percent():
    """The elastic-plan family's warm-plan floor: unchanged queues
    replan from the resident demand/capacity tensors, and the port moves
    the reference's bytes."""
    assert _warm_case(PORT) == _warm_case(REF)


def _on_off(P, resident_on):
    store, cluster, queues, job = _elastic_rig(P)
    planner = _planner(P, store, cluster, resident_on)
    out = []
    for i in range(3):
        if i == 2:
            queues["p0"].jobs.append(job("p0", 99))
        record = planner.plan_cycle(queues)
        out.append((record.demand, record.moves, record.unmet))
    return out


def test_elastic_plans_identical_resident_on_off():
    port = _on_off(PORT, True)
    assert port == _on_off(PORT, False)
    ref = _on_off(REF, True)
    assert ref == _on_off(REF, False)
    for (dp, mp, up), (dr, mr, ur) in zip(port, ref):
        _same_per_pool(dp, dr)
        same_moves(mp, mr)
        _same_per_pool(up, ur)


@PKGS
def test_elastic_queue_growth_within_bucket_is_one_delta_row(P):
    store, cluster, queues, job = _elastic_rig(P)
    planner = _planner(P, store, cluster, True)
    planner.plan_cycle(queues)
    planner.plan_cycle(queues)
    queues["p1"].jobs.append(job("p1", 99))
    planner.plan_cycle(queues)
    assert planner._resident.last["rebuild"] is False
    assert planner._resident.last["delta_rows"] == 1


@PKGS
def test_elastic_queue_bucket_growth_rebuilds_width_changed(P):
    store, cluster, queues, job = _elastic_rig(P, queue_len=8)
    planner = _planner(P, store, cluster, True)
    planner.plan_cycle(queues)
    queues["p0"].jobs.extend(job("p0", 100 + k) for k in range(128))
    planner.plan_cycle(queues)
    assert planner._resident.last["rebuild"] is True
    assert planner._resident.last["reason"] == "width-changed"


def test_cli_elastic_run_equals_the_reference(tmp_path):
    """`sim.cli run --elastic` on the imbalanced trace: the same run
    trace as the reference CLI's, and the summary counts the committed
    plans."""
    from cook_tpu.sim import cli as ref_cli
    from cook_tpu_torch.sim import cli as port_cli

    trace = str(tmp_path / "imb.json")
    assert port_cli.main(["synth", "--imbalanced", "--jobs", "24",
                          "--out", trace]) == 0
    args = ["run", "--trace", trace, "--chunk", "0", "--elastic"]
    assert port_cli.main([*args, "--out", str(tmp_path / "p.csv"),
                          "--device", "cpu"]) == 0
    assert ref_cli.main([*args, "--out", str(tmp_path / "r.csv")]) == 0
    with open(tmp_path / "p.csv") as f, open(tmp_path / "r.csv") as g:
        assert f.read() == g.read()


def _stranded(P, elastic_every):
    jobs, hosts = P.loadgen.imbalanced_pool_trace(
        busy_jobs=16, busy_hosts=2, idle_hosts=2, runtime_ms=60_000)
    return P.sim.Simulator(jobs, hosts, P.sim.SimConfig(
        cycle_ms=30_000, max_cycles=30, elastic_every=elastic_every,
        pools=(("busy", "default"), ("idle", "default"))), **P.kw).run()


def test_stranded_memory_hides_the_shortage_like_the_reference():
    """ROADMAP Queue C, reference item 9, reproduced on purpose: two busy
    hosts of 64 GB / 32 cpus run four 8 GB / 8 cpu jobs each and strand
    64 GB between them, as much as the 8 queued jobs' rank-weighted
    memory.  The pool's scalar spare covers the memory, so every loan
    carries cpus and no memory, the elastic host places nothing, and the
    run equals the static one, on both packages."""
    for P in (REF, PORT):
        static, elastic = _stranded(P, 0), _stranded(P, 1)
        loans = [m for p in elastic.elastic_plans for m in p["moves"]]
        assert loans and all(m["kind"] == "loan" and m["mem"] == 0.0
                             and m["cpus"] > 0 for m in loans)
        assert not any(r["host"].startswith("elastic@")
                       for r in elastic.rows)
        assert elastic.to_csv() == static.to_csv()
    assert _stranded(PORT, 1).to_csv() == _stranded(REF, 1).to_csv()


# the multi-pool slice's shape at a CPU test's size (as
# tests/test_torch_multipool.py runs chip_smoke's multipool phases)
SMALL_POOLS = (("alpha", 300, 100, "default"),) + tuple(
    (f"pool{k}", 100, 20, "gpu" if k == 3 else "default")
    for k in range(1, 4))
SMALL_MATCH = dict(hierarchical_threshold=100_000,
                   hierarchical_nodes_per_block=32)


def test_chip_smoke_elastic_phases_on_cpu(capsys):
    """chip_smoke.py's elastic phases on the CPU at small sizes: the solve
    at [8, 512] against the oracles (the full reclaim exact, the pinned
    holds_borrowed), the small multi-pool slice planning every cycle
    under the probe's checks with every plan solved again, the resident
    plan mirror, and the agreement replays with the A/B at 48 jobs."""
    import chip_smoke

    rows = chip_smoke.elastic_solve_phase(device="cpu", shapes=((8, 512),))
    assert rows["elastic 8x512"]["moves"] > 0
    # 3 cycles, as the card ran them before the script's depth went to 2
    launches, errs, queues, trace = chip_smoke.elastic_slice_phase(
        device="cpu", pools=SMALL_POOLS, match_overrides=SMALL_MATCH,
        classic_placed=[0, 0, 0], cycles=3)
    assert launches == {"best_node": 0, "coarse_pass": 0,
                        "best_node_batched": 0}
    assert errs["elastic"] == 0.0
    cold, warm = chip_smoke.elastic_residency_phase(queues, trace,
                                                    device="cpu")
    assert cold > 0 and all(b <= 0.1 * cold for b in warm)
    p50 = chip_smoke.elastic_agreement_phase(
        devices=("cpu",), ab=dict(busy_jobs=48, busy_hosts=2,
                                  idle_hosts=4), ab_cycles=60)
    assert p50[1] < p50[0]
    out = capsys.readouterr().out
    for line in ("elastic multipool cycle 3", "plans solved again",
                 "plans equal with the mirror off and on",
                 "elastic agreement: loan, failover", "elastic A/B"):
        assert line in out
