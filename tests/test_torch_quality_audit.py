"""The exact-kernel quality audit of `cook_tpu_torch.scheduler.matcher`
against `cook_tpu`'s on the CPU: the cases of tests/test_tuned_service.py
:91-146 (every-cycle audit, disabled at 0, the batched path) and
tests/test_data_plane.py:292 (the audit's bytes under the `fallback`
family) on both packages, and the `match.quality_audit` gauge equal to
the reference's on the same problem and assignment — a contended
chunked solve on the `pallas` backend, where the chunked assignment
places less than the exact greedy (chunked parity holds on `pallas`:
ROADMAP Queue C port item 3).  The audit only observes: the cycle's
launches do not depend on it."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cook_tpu.cluster import mock as ref_mock
from cook_tpu.models import entities as ref_ent
from cook_tpu.models import store as ref_store
from cook_tpu.obs import data_plane as ref_dp
from cook_tpu.scheduler import core as ref_core
from cook_tpu.scheduler import matcher as ref_matcher
from cook_tpu.utils import metrics as ref_metrics
from cook_tpu_torch.cluster import mock as port_mock
from cook_tpu_torch.models import entities as port_ent
from cook_tpu_torch.models import store as port_store
from cook_tpu_torch.obs import data_plane as port_dp
from cook_tpu_torch.scheduler import core as port_core
from cook_tpu_torch.scheduler import matcher as port_matcher
from cook_tpu_torch.scheduler.flight_recorder import NULL_CYCLE
from cook_tpu_torch.utils import metrics as port_metrics
from tests.conftest import FakeClock

# one intra-op thread: the suite runs several pytest-xdist workers side
# by side, and idle OpenMP threads spinning in each would crowd them
torch.set_num_threads(1)

REF = SimpleNamespace(name="ref", mock=ref_mock, ent=ref_ent,
                      store=ref_store, core=ref_core, matcher=ref_matcher,
                      metrics=ref_metrics, dp=ref_dp, kw={})
PORT = SimpleNamespace(name="port", mock=port_mock, ent=port_ent,
                       store=port_store, core=port_core,
                       matcher=port_matcher, metrics=port_metrics,
                       dp=port_dp, kw={"device": "cpu"})
PKGS = pytest.mark.parametrize("P", [REF, PORT], ids=["ref", "port"])


def _gauge(P):
    return P.metrics.global_registry.gauge("match.quality_audit")


def _join_audit(P):
    thread = P.matcher.last_audit_thread
    assert thread is not None
    thread.join(timeout=60)
    assert not thread.is_alive()


def _scheduler(P, pools=("default",), hosts_per_pool=4, **match_kw):
    clock = FakeClock()
    store = P.store.JobStore(clock=clock)
    for name in pools:
        store.set_pool(P.ent.Pool(name=name))
    cluster = P.mock.MockCluster("mock", [
        P.mock.MockHost(node_id=f"{p}h{i}", hostname=f"{p}h{i}", mem=4000,
                        cpus=8, pool=p)
        for p in pools for i in range(hosts_per_pool)], clock=clock)
    scheduler = P.core.Scheduler(store, [cluster], P.core.SchedulerConfig(
        match=P.matcher.MatchConfig(**match_kw)), **P.kw)
    return store, cluster, scheduler


def _job(P, pool="default", mem=500.0, cpus=1.0, uuid=None):
    e = P.ent
    return e.Job(uuid=uuid or e.new_uuid(), user="u1", pool=pool,
                 priority=50, max_retries=1, command="true",
                 resources=e.Resources(mem=mem, cpus=cpus))


@PKGS
def test_audit_gauges_parity_every_cycle(P):
    """tests/test_tuned_service.py:92: a tiny uncontended problem audited
    every cycle gauges 1.0, and the cycle's jobs run."""
    store, _, scheduler = _scheduler(P, chunk=64, quality_audit_every=1)
    _gauge(P).set(-1.0, labels={"pool": "default"})
    store.submit_jobs([_job(P) for _ in range(8)])
    pool = store.pools["default"]
    scheduler.rank_cycle(pool)
    scheduler.match_cycle(pool)
    _join_audit(P)
    assert _gauge(P).value(labels={"pool": "default"}) == pytest.approx(1.0)
    assert all(j.state is P.ent.JobState.RUNNING
               for j in store.jobs.values())


@PKGS
def test_audit_disabled_at_zero(P):
    store, _, scheduler = _scheduler(P, chunk=64, quality_audit_every=0)
    _gauge(P).set(-2.0, labels={"pool": "default"})
    store.submit_jobs([_job(P)])
    pool = store.pools["default"]
    scheduler.rank_cycle(pool)
    scheduler.match_cycle(pool)
    assert _gauge(P).value(labels={"pool": "default"}) == -2.0


@PKGS
def test_audit_covers_batched_path(P):
    """tests/test_tuned_service.py:124: the pool-batched pass counts each
    flat lane's chunked solve toward its pool's audit."""
    store, _, scheduler = _scheduler(P, pools=("pool0", "pool1"),
                                     hosts_per_pool=2, chunk=64,
                                     quality_audit_every=1)
    for p in range(2):
        _gauge(P).set(-3.0, labels={"pool": f"pool{p}"})
    store.submit_jobs([_job(P, pool=f"pool{p}") for p in range(2)
                       for _ in range(4)])
    scheduler.match_cycle_all_pools()
    _join_audit(P)  # single-flight: at least one pool's audit ran
    ratios = [_gauge(P).value(labels={"pool": f"pool{p}"})
              for p in range(2)]
    assert any(r == pytest.approx(1.0) for r in ratios)


def test_audit_bytes_land_under_the_fallback_family():
    """tests/test_data_plane.py:292 on the port: the audit's put of the
    problem and its fetches land in the `fallback` family, and no device
    family moves."""
    store, _, scheduler = _scheduler(PORT, chunk=0)
    store.submit_jobs([_job(PORT, mem=200)])
    pool = store.pools["default"]
    queue = scheduler.rank_cycle(pool)
    prepared = port_matcher.prepare_pool_problem(
        store, pool, queue, scheduler.clusters, port_matcher.MatchConfig(),
        port_matcher.PoolMatchState(num_considerable=100),
        device=torch.device("cpu"), flight=NULL_CYCLE)
    assert prepared.solvable
    before = port_dp.LEDGER.family_totals()

    def fam(totals, name):
        slot = totals.get(name, {})
        return slot.get("h2d_bytes", 0), slot.get("d2h_bytes", 0)

    port_matcher.audit_match_quality(prepared.problem, 1,
                                     np.zeros(1, np.int32), "default")
    after = port_dp.LEDGER.family_totals()
    fb0, fb1 = fam(before, port_dp.FAM_FALLBACK), fam(after,
                                                      port_dp.FAM_FALLBACK)
    assert fb1[0] > fb0[0] and fb1[1] > fb0[1]
    for name in (port_dp.FAM_NODE_ENCODE, port_dp.FAM_FEASIBILITY):
        assert fam(after, name) == fam(before, name), name


CONTENDED = dict(chunk=16, chunk_rounds=1, chunk_passes=1, chunk_kc=1,
                 backend="pallas", quality_audit_every=1,
                 max_jobs_considered=64)


def _contended_cycle(P):
    """A contended chunked cycle: 48 jobs of mixed sizes on 4 hosts, one
    candidate pass of single candidates, so the chunked solve places less
    than the exact greedy would.  Returns (the gauge, the launches)."""
    rng = np.random.default_rng(4)
    store, _, scheduler = _scheduler(P, **CONTENDED)
    _gauge(P).set(-4.0, labels={"pool": "default"})
    store.submit_jobs([_job(P, mem=float(rng.choice([256, 512, 1024,
                                                     1536])),
                            cpus=float(rng.choice([0.5, 1, 2])),
                            uuid=f"c{i:03d}") for i in range(48)])
    pool = store.pools["default"]
    scheduler.rank_cycle(pool)
    outcome = scheduler.match_cycle(pool)
    _join_audit(P)
    return (_gauge(P).value(labels={"pool": "default"}),
            sorted((j.uuid, o.hostname) for j, o in outcome.matched))


def test_audit_gauge_equals_the_reference_on_a_contended_solve():
    """The same contended cycle on both packages: the same launches, and
    the audit's ratio — the chunked assignment's placed demand weight over
    the exact greedy's, both read off the same problem — equal, and below
    1 (the audit saw the chunked solve's shortfall)."""
    got, got_matched = _contended_cycle(PORT)
    want, want_matched = _contended_cycle(REF)
    assert got_matched == want_matched
    assert 0.0 < got < 1.0
    assert got == pytest.approx(want, rel=1e-6)
