"""Columnar rank of `cook_tpu_torch` against `cook_tpu` on the CPU.

- `models/columnar.ColumnarJobIndex`: the same store operations (submit,
  launch, complete, kill, pool move, a `rebuild` mid-stream) leave the
  port's index with the reference index's columns, dtypes and interned
  names;
- `scheduler/ranking_columnar.rank_pool_columnar`: job order, DRU values,
  capped and quarantined jobs equal the reference's on seeded stores
  (quota caps, the offensive-job filter, running usage, equal-DRU ties
  across users);
- the two rank paths' tie order: on equal-DRU jobs of users whose
  first-seen order is not alphabetical, both packages' `rank_pool` agree,
  both columnar paths agree, and the two paths differ (the columnar user
  code is the index's intern order, `rank_pool`'s the alphabetical one).

Every input is exact in float32 (MB in multiples of 512, cpus in halves,
power-of-two shares), so the DRU values are compared exactly."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cook_tpu.models import columnar as ref_columnar
from cook_tpu.models import entities as ref_ent
from cook_tpu.models import store as ref_store
from cook_tpu.scheduler import ranking as ref_ranking
from cook_tpu.scheduler import ranking_columnar as ref_rc
from cook_tpu_torch.models import columnar as port_columnar
from cook_tpu_torch.models import entities as port_ent
from cook_tpu_torch.models import store as port_store
from cook_tpu_torch.scheduler import ranking as port_ranking
from cook_tpu_torch.scheduler import ranking_columnar as port_rc
from tests.conftest import FakeClock

# one intra-op thread: the suite runs several pytest-xdist workers side
# by side, and idle OpenMP threads spinning in each would crowd them
torch.set_num_threads(1)

REF = SimpleNamespace(ent=ref_ent, store=ref_store, columnar=ref_columnar,
                      ranking=ref_ranking, rc=ref_rc, kw={})
PORT = SimpleNamespace(ent=port_ent, store=port_store,
                       columnar=port_columnar, ranking=port_ranking,
                       rc=port_rc, kw={"device": "cpu"})

# first-seen order is not alphabetical: the columnar user codes and
# rank_pool's differ
USERS = ("zed", "amy", "kim", "bob", "lou")
COLUMNS = ("user_code", "pool_code", "mem", "cpus", "gpus", "disk",
           "priority", "submit_ms", "state")


def _job(P, uuid, user, rng, pool="default", submit=None):
    return P.ent.Job(
        uuid=uuid, user=user, pool=pool, command="x",
        priority=int(rng.choice([25, 50, 75])),
        submit_time_ms=int(submit if submit is not None
                           else rng.integers(0, 50_000)),
        resources=P.ent.Resources(
            mem=float(rng.choice([512, 1024, 2048, 4096])),
            cpus=float(rng.choice([0.5, 1.0, 2.0])),
            gpus=float(rng.choice([0.0, 0.0, 1.0]))))


def _drive(P, seed, *, rebuild_at=None, n_jobs=60):
    """A seeded stream of store operations; returns (store, index,
    clock).  The index is built first, so it follows the stream's
    events; `rebuild_at` rebuilds it from the store after that many
    operations."""
    rng = np.random.default_rng(seed)
    clock = FakeClock()
    store = P.store.JobStore(clock=clock)
    for name in ("default", "other"):
        store.set_pool(P.ent.Pool(name=name))
    index = P.columnar.ColumnarJobIndex(store)
    running: list[str] = []
    waiting: list[str] = []
    task = 0
    for op in range(n_jobs):
        if rebuild_at is not None and op == rebuild_at:
            index.rebuild()
        clock.advance(int(rng.integers(1, 2000)))
        kind = rng.choice(["submit", "submit", "launch", "complete",
                           "kill", "move"])
        if kind == "submit" or not waiting:
            uuid = f"j{op:03d}"
            user = USERS[min(int(rng.integers(0, len(USERS) + 2)),
                             len(USERS) - 1)]
            pool = "other" if rng.random() < 0.2 else "default"
            # some jobs take the store's clock as their submit time
            submit = 0 if rng.random() < 0.3 else None
            store.submit_jobs([_job(P, uuid, user, rng, pool, submit)])
            waiting.append(uuid)
        elif kind == "launch":
            uuid = waiting.pop(int(rng.integers(0, len(waiting))))
            task += 1
            store.create_instance(uuid, f"t{task}", hostname=f"h{task % 7}",
                                  node_id=f"h{task % 7}")
            running.append(f"t{task}")
        elif kind == "complete" and running:
            tid = running.pop(int(rng.integers(0, len(running))))
            status = (P.ent.InstanceStatus.SUCCESS if rng.random() < 0.7
                      else P.ent.InstanceStatus.FAILED)
            store.update_instance_state(tid, P.ent.InstanceStatus.RUNNING,
                                        None)
            store.update_instance_state(tid, status, None)
        elif kind == "kill":
            uuid = waiting.pop(int(rng.integers(0, len(waiting))))
            store.kill_jobs([uuid])
        elif kind == "move":
            uuid = waiting[int(rng.integers(0, len(waiting)))]
            to = "other" if store.jobs[uuid].pool == "default" else "default"
            assert store.move_job_pool(uuid, to)
    return store, index, clock


def _index_view(index):
    n = index._n
    live = len(index._inst_rows)
    view = {name: getattr(index, name)[:n] for name in COLUMNS}
    view["uuids"] = index.uuids[:n]
    view["users"] = list(index.users.names)
    view["pools"] = list(index.pools.names)
    view["inst_job_row"] = index.inst_job_row[:live]
    view["inst_start"] = index.inst_start[:live]
    view["inst_tids"] = index._inst_tids[:live]
    view["inst_rows"] = dict(index._inst_rows)
    return view


def _assert_views_equal(got, want):
    assert set(got) == set(want)
    for key, value in want.items():
        if isinstance(value, np.ndarray):
            assert got[key].dtype == value.dtype, key
            np.testing.assert_array_equal(got[key], value, err_msg=key)
        else:
            assert got[key] == value, key


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("rebuild_at", [None, 25])
def test_index_columns_equal_reference(seed, rebuild_at):
    _, want, _ = _drive(REF, seed, rebuild_at=rebuild_at)
    store, got, _ = _drive(PORT, seed, rebuild_at=rebuild_at)
    _assert_views_equal(_index_view(got), _index_view(want))
    assert got.consistent_with_store()
    # a rebuild from scratch reproduces the incrementally kept columns
    # (live instances in the store's order, which rebuild takes)
    kept = _index_view(got)
    got.rebuild()
    rebuilt = _index_view(got)
    for key in COLUMNS + ("uuids", "users", "pools"):
        assert np.array_equal(np.asarray(rebuilt[key]),
                              np.asarray(kept[key])), key
    assert sorted(rebuilt["inst_tids"]) == sorted(kept["inst_tids"])


def test_pool_move_updates_the_index_and_emits_the_event():
    for P in (REF, PORT):
        clock = FakeClock()
        store = P.store.JobStore(clock=clock)
        for name in ("default", "other"):
            store.set_pool(P.ent.Pool(name=name))
        index = P.columnar.ColumnarJobIndex(store)
        events = []
        store.add_watcher(events.append)
        rng = np.random.default_rng(0)
        store.submit_jobs([_job(P, "a", "amy", rng)])
        assert store.move_job_pool("a", "other")
        assert not store.move_job_pool("a", "nowhere")
        assert not store.move_job_pool("missing", "default")
        assert events[-1].kind == "job/pool-moved"
        assert events[-1].data == {"uuid": "a", "from": "default",
                                   "to": "other"}
        assert store.jobs["a"].pool == "other"
        assert [j.uuid for j in store.pending_jobs("other")] == ["a"]
        assert store.pending_jobs("default") == []
        assert index.pools.names[index.pool_code[0]] == "other"
        store.create_instance("a", "t1", hostname="h")
        assert not store.move_job_pool("a", "default")   # no longer waiting


def _rank_store(P, seed, *, quotas=False):
    """A seeded pool: running usage, shares, and (optionally) quotas."""
    store, index, clock = _drive(P, seed, n_jobs=80)
    rng = np.random.default_rng(seed + 100)
    # a backlog beside the stream's survivors: every user queues jobs
    store.submit_jobs([_job(P, f"q{i:02d}", USERS[i % len(USERS)], rng)
                       for i in range(20)])
    for i, user in enumerate(USERS):
        store.set_share(P.ent.Share(
            user=user, pool="default",
            resources=P.ent.Resources(mem=float(2 ** (12 + i % 3)),
                                      cpus=float(2 ** (i % 3)))))
        if quotas and i % 2 == 0:
            store.set_quota(P.ent.Quota(
                user=user, pool="default",
                resources=P.ent.Resources(mem=8192.0, cpus=4.0, gpus=1.0),
                count=3))
    return store, index


def _queue_view(queue):
    return ([j.uuid for j in queue.jobs], dict(queue.dru),
            list(queue.capped), list(queue.quarantined), queue.solve_shape)


@pytest.mark.parametrize("seed", [3, 4, 5])
@pytest.mark.parametrize("quotas", [False, True], ids=["shares", "quotas"])
@pytest.mark.parametrize("limits", [None, (2048.0, 1.0, 1.0)],
                         ids=["all", "offensive-filter"])
def test_rank_pool_columnar_equals_reference(seed, quotas, limits):
    views = []
    for P in (REF, PORT):
        store, index = _rank_store(P, seed, quotas=quotas)
        pool = store.pools["default"]
        views.append(_queue_view(P.rc.rank_pool_columnar(
            store, index, pool, capacity_limits=limits, **P.kw)))
    want, got = views
    assert got == want
    assert got[0], "the seeded pool ranks no job"
    if quotas:
        assert got[2], "the quotas capped no job"
    if limits is not None:
        assert got[3], "the offensive filter quarantined no job"


def _tie_store(P):
    """Equal-DRU ties across users: "zed" and "amy" (first seen in that
    order) each submit identical jobs at the same time and priority, under
    equal shares, with nothing running."""
    rng = np.random.default_rng(0)
    store = P.store.JobStore(clock=FakeClock())
    store.set_pool(P.ent.Pool(name="default"))
    index = P.columnar.ColumnarJobIndex(store)
    jobs = []
    for i in range(3):
        for user in ("zed", "amy"):
            job = _job(P, f"{user}-{i}", user, rng, submit=1000 + i)
            jobs.append(P.ent.Job(**{**vars(job), "priority": 50,
                                     "resources": P.ent.Resources(
                                         mem=1024.0, cpus=1.0)}))
    store.submit_jobs(jobs)
    return store, index


def test_equal_dru_tie_order_differs_between_the_rank_paths():
    """The cause of the reference's two rank paths disagreeing: each
    package's `rank_pool` puts amy's job first (alphabetical user code),
    each columnar path zed's (first-seen intern order)."""
    plain, columnar = [], []
    for P in (REF, PORT):
        store, index = _tie_store(P)
        pool = store.pools["default"]
        plain.append(_queue_view(P.ranking.rank_pool(store, pool, **P.kw)))
        columnar.append(_queue_view(P.rc.rank_pool_columnar(
            store, index, pool, **P.kw)))
    assert plain[0] == plain[1]
    assert columnar[0] == columnar[1]
    assert plain[0][0] != columnar[0][0]
    assert plain[0][0][:2] == ["amy-0", "zed-0"]
    assert columnar[0][0][:2] == ["zed-0", "amy-0"]
    # the same DRU values, only the order of the ties differs
    assert plain[0][1] == columnar[0][1]


def test_pending_tie_break_row_follows_job_seq():
    """Index rows are never deleted and follow the store's job/created
    order, the order `store.job_seq` records for `rank_pool`."""
    store, index, _ = _drive(PORT, 7)
    rows = {uuid: index._rows[uuid] for uuid in store.jobs}
    assert sorted(rows, key=rows.get) == sorted(store.job_seq,
                                                key=store.job_seq.get)
