"""The sharded store of `cook_tpu_torch` against `cook_tpu` on the CPU.

- The 13 cases of tests/test_shard_control_plane.py (the router, the
  partitioned store's merged views, pool-scoped routing, broadcast pool
  metadata and meta-shard globals, cross-shard pool moves, the commit
  pipeline's per-shard idempotency, all-or-nothing vetoes and deadlock
  freedom) and the 7 of tests/test_shard_persistence.py (per-shard
  recovery, a cross-shard move replayed from two segments, snapshots,
  the on-disk shard count, the exactly-once migration), each on both
  packages (`P` over `ref` / `port`) with the reference's assertions.
- Across the packages: both routers route 1,000 pools and users alike at
  2, 3, 4 and 8 shards; a sharded data_dir, or a migration, written by
  either package recovers in the other with equal per-shard
  `snapshot_state`; a sharded follower of either package tails a sharded
  leader of the other to equal per-shard snapshots.
"""
import json
import os
import threading
import time
from types import SimpleNamespace

import pytest
import requests
import torch

from cook_tpu import shard as ref_shard
from cook_tpu.models import entities as ref_ent
from cook_tpu.models import persistence as ref_persist
from cook_tpu.models import store as ref_store
from cook_tpu.rest import server as ref_server
from cook_tpu.shard import journal as ref_journal
from cook_tpu.shard import replica as ref_replica
from cook_tpu.shard import router as ref_router
from cook_tpu_torch import shard as port_shard
from cook_tpu_torch.models import entities as port_ent
from cook_tpu_torch.models import persistence as port_persist
from cook_tpu_torch.models import store as port_store
from cook_tpu_torch.rest import server as port_server
from cook_tpu_torch.shard import journal as port_journal
from cook_tpu_torch.shard import replica as port_replica
from cook_tpu_torch.shard import router as port_router

torch.set_num_threads(1)

REF = SimpleNamespace(name="ref", ent=ref_ent, store=ref_store,
                      persist=ref_persist, shard=ref_shard,
                      journal=ref_journal, router=ref_router,
                      replica=ref_replica, server=ref_server)
PORT = SimpleNamespace(name="port", ent=port_ent, store=port_store,
                       persist=port_persist, shard=port_shard,
                       journal=port_journal, router=port_router,
                       replica=port_replica, server=port_server)
PKGS = pytest.mark.parametrize("P", [REF, PORT], ids=["ref", "port"])
PAIRS = pytest.mark.parametrize(
    "W,R", [(REF, PORT), (PORT, REF)], ids=["ref-to-port", "port-to-ref"])
ADMIN = {"X-Cook-Requesting-User": "admin"}
TIMEOUT_S = 15


def job(P, uuid, pool, user="u0", **kw):
    e = P.ent
    return e.Job(uuid=uuid, user=user, pool=pool, command="true",
                 resources=e.Resources(mem=64, cpus=1), **kw)


def plane(P, n_shards=4):
    store = P.shard.ShardedStore(n_shards)
    router = store.router
    pools = router.pools_for_distinct_shards()
    for name in pools:
        store.set_pool(P.ent.Pool(name=name))
    txn = P.shard.ShardedTransactionLog(store)
    return store, txn, router, pools


def shard_states(P, store) -> list:
    """Per-shard `snapshot_state`, through JSON (as a snapshot file or
    the replication feed carries it)."""
    return [json.loads(json.dumps(P.persist.snapshot_state(shard)))
            for shard in store.shards]


# ------------------------------------------------------------------ router


@PKGS
def test_router_is_deterministic_and_stable(P):
    a, b = P.shard.ShardRouter(8), P.shard.ShardRouter(8)
    for pool in ("prod", "dev", "gpu-a", "gpu-b"):
        assert a.shard_for_pool(pool) == b.shard_for_pool(pool)
    for user in ("alice", "bob"):
        assert a.shard_for_user(user) == b.shard_for_user(user)


@PKGS
def test_router_distinct_pool_helper(P):
    router = P.shard.ShardRouter(4)
    pools = router.pools_for_distinct_shards()
    shards = [router.shard_for_pool(p) for p in pools]
    assert sorted(shards) == [0, 1, 2, 3]


@PKGS
def test_router_plan_routes_by_pool_and_falls_back_to_user(P):
    store, _, router, pools = plane(P)
    plan = router.plan("jobs/submit", {"jobs": [job(P, "a", pools[2])]},
                       store)
    assert plan.single == router.shard_for_pool(pools[2])
    # unknown job uuid: pool-less key -> hashed-user fallback, still
    # deterministic so the veto lands on one consistent shard
    plan = router.plan("job/retry", {"uuid": "nope"}, store)
    assert plan.single == router.shard_for_user("nope")
    # global ops own the meta shard
    assert router.plan("config/update", {"updates": {}},
                       store).single == P.router.META_SHARD


@pytest.mark.parametrize("n_shards", [2, 3, 4, 8])
def test_routers_agree_key_for_key(n_shards):
    """Each package's journals replay in the other only if both route
    every key to the same shard."""
    ref, port = ref_shard.ShardRouter(n_shards), \
        port_shard.ShardRouter(n_shards)
    names = [f"name-{i}" for i in range(1000)]
    assert [port.shard_for_pool(n) for n in names] == \
        [ref.shard_for_pool(n) for n in names]
    assert [port.shard_for_user(n) for n in names] == \
        [ref.shard_for_user(n) for n in names]
    assert port.pools_for_distinct_shards() == \
        ref.pools_for_distinct_shards()
    assert len({port.shard_for_pool(n) for n in names}) == n_shards


# ------------------------------------------------------------------- store


@PKGS
def test_sharded_store_partitions_and_merges(P):
    store, txn, router, pools = plane(P)
    uuids = []
    for i in range(12):
        u = f"j{i:02d}"
        uuids.append(u)
        txn.commit("jobs/submit", {"jobs": [job(P, u, pools[i % 4])]})
    # every shard owns exactly its pools' jobs
    for i, shard in enumerate(store.shards):
        for u in shard.jobs:
            assert router.shard_for_pool(shard.jobs[u].pool) == i
    assert len(store.jobs) == 12
    assert sorted(store.jobs.keys()) == uuids
    assert "j03" in store.jobs
    assert store.jobs["j03"].pool == pools[3]
    # pool-scoped reads route to one shard and see only its jobs
    assert {j.uuid for j in store.pending_jobs(pools[1])} == {
        "j01", "j05", "j09"}
    assert store.pending_count(pools[1]) == 3
    assert store.pending_count() == 12


@PKGS
def test_pool_metadata_broadcasts_and_meta_shard_owns_globals(P):
    store, txn, _, pools = plane(P)
    meta = P.router.META_SHARD
    for shard in store.shards:
        assert set(shard.pools) == set(pools)
    txn.commit("config/update", {"updates": {"k": 1}})
    assert store.dynamic_config == {"k": 1}
    assert store.shards[meta].dynamic_config == {"k": 1}
    for i, shard in enumerate(store.shards):
        if i != meta:
            assert shard.dynamic_config == {}
    outcome = txn.commit("pool/capacity-delta", {"moves": [
        {"kind": "loan", "from": pools[0], "to": pools[1],
         "mem": 100.0}]})
    assert outcome.result["applied"] == 1
    assert store.encoded_capacity_ledger()[0]["mem"] == 100.0


@PKGS
def test_share_quota_route_by_pool(P):
    e = P.ent
    store, txn, router, pools = plane(P)
    txn.commit("share/set", {"share": e.Share(
        user="alice", pool=pools[2],
        resources=e.Resources(mem=10, cpus=1, gpus=0))})
    owner = store.shards[router.shard_for_pool(pools[2])]
    assert ("alice", pools[2]) in owner.shares
    assert store.get_share("alice", pools[2]).mem == 10
    txn.commit("quota/set", {"quota": e.Quota(
        user="alice", pool=pools[2],
        resources=e.Resources(mem=5, cpus=1, gpus=0), count=3)})
    assert store.get_quota("alice", pools[2]).count == 3


@PKGS
def test_instance_lifecycle_routes_by_owning_shard(P):
    e = P.ent
    store, txn, router, pools = plane(P)
    txn.commit("jobs/submit", {"jobs": [job(P, "run-me", pools[3])]})
    inst = store.create_instance("run-me", "task-1", hostname="h0")
    owner = store.shards[router.shard_for_pool(pools[3])]
    assert inst.task_id in owner.instances
    assert store.jobs["run-me"].state is e.JobState.RUNNING
    assert [j.uuid for j in store.running_jobs(pools[3])] == ["run-me"]
    update = store.update_instance_state("task-1",
                                         e.InstanceStatus.SUCCESS)
    assert update.applied
    assert store.jobs["run-me"].state is e.JobState.COMPLETED
    assert store.job_instances("run-me")[0].status is \
        e.InstanceStatus.SUCCESS


def test_pinned_pool_store_reads_one_shard():
    """`store_for_pool` (what `Scheduler._pool_store` hands a per-pool
    cycle) is the pool's own shard, with the merged `groups`; a plain
    JobStore is its own pool store."""
    from cook_tpu_torch.scheduler.core import Scheduler

    store, txn, router, pools = plane(PORT, n_shards=2)
    txn.commit("jobs/submit", {"jobs": [job(PORT, "p0", pools[0]),
                                        job(PORT, "p1", pools[1])]})
    pinned = store.store_for_pool(pools[1])
    assert pinned._lock is store.shards[router.shard_for_pool(
        pools[1])]._lock
    assert set(pinned.jobs) == {"p1"}
    assert pinned.groups is store.groups
    scheduler = Scheduler(store, [], device="cpu")
    assert scheduler._pool_store(store.pools[pools[0]]).jobs is \
        store.shards[router.shard_for_pool(pools[0])].jobs
    plain = port_store.JobStore()
    plain.set_pool(port_ent.Pool(name="default"))
    assert Scheduler(plain, [], device="cpu")._pool_store(
        plain.pools["default"]) is plain


# ------------------------------------------------------- cross-shard moves


@PKGS
def test_cross_shard_pool_move(P):
    store, txn, router, pools = plane(P)
    src_pool, dst_pool = pools[0], pools[3]
    txn.commit("jobs/submit", {"jobs": [job(P, "mover", src_pool)]})
    outcome = txn.commit("job/pool-move",
                         {"uuid": "mover", "pool": dst_pool})
    assert outcome.result["moved"] is True
    assert set(outcome.shard_seqs) == {router.shard_for_pool(src_pool),
                                       router.shard_for_pool(dst_pool)}
    src = store.shards[router.shard_for_pool(src_pool)]
    dst = store.shards[router.shard_for_pool(dst_pool)]
    assert "mover" not in src.jobs
    assert dst.jobs["mover"].pool == dst_pool
    assert [j.uuid for j in store.pending_jobs(dst_pool)] == ["mover"]
    assert store.pending_jobs(src_pool) == []
    # the source shard's own journal feed carries the shard-out, the
    # destination's the upsert — per-segment replay stays self-contained
    src_kinds = [e.kind for e in src.events_since(0)]
    dst_kinds = [e.kind for e in dst.events_since(0)]
    assert "job/shard-out" in src_kinds
    assert "job/pool-moved" in dst_kinds


@PKGS
def test_cross_shard_move_only_moves_waiting_jobs(P):
    store, txn, router, pools = plane(P)
    txn.commit("jobs/submit", {"jobs": [job(P, "busy", pools[0])]})
    store.create_instance("busy", "t-busy", hostname="h0")
    outcome = txn.commit("job/pool-move",
                         {"uuid": "busy", "pool": pools[3]})
    assert outcome.result["moved"] is False
    assert store.jobs["busy"].pool == pools[0]


# ------------------------------------------------------------ txn pipeline


@PKGS
def test_idempotent_replay_single_and_cross_shard(P):
    store, txn, router, pools = plane(P)
    first = txn.commit("jobs/submit", {"jobs": [job(P, "one", pools[1])]},
                       txn_id="t-1")
    replay = txn.commit("jobs/submit", {"jobs": [job(P, "one", pools[1])]},
                        txn_id="t-1")
    assert not first.duplicate and replay.duplicate
    assert replay.result == first.result
    # cross-shard submit: one txn spanning two shards dedupes from
    # EITHER shard's idempotency table
    batch = [job(P, "x-a", pools[0]), job(P, "x-b", pools[2])]
    first = txn.commit("jobs/submit", {"jobs": batch}, txn_id="t-2")
    assert len(first.shard_seqs) == 2
    replay = txn.commit("jobs/submit", {"jobs": batch}, txn_id="t-2")
    assert replay.duplicate
    # the duplicate answer reconstructs the PER-SHARD seq vector from
    # each shard's sealed record — batch replication waits must never
    # misattribute the coordinator's seq to shard 0
    assert replay.shard_seqs == first.shard_seqs
    assert len(store.jobs) == 3
    for i in first.shard_seqs:
        assert "t-2" in store.shards[i].txn_results


@PKGS
def test_cross_shard_submit_veto_is_all_or_nothing(P):
    store, txn, _, pools = plane(P)
    txn.commit("jobs/submit", {"jobs": [job(P, "taken", pools[2])]})
    with pytest.raises(P.store.TransactionVetoed):
        txn.commit("jobs/submit", {"jobs": [
            job(P, "fresh", pools[0]), job(P, "taken", pools[2])]})
    # the veto on the second shard must not leave the first shard's half
    assert "fresh" not in store.jobs


@PKGS
def test_concurrent_cross_shard_commits_do_not_deadlock(P):
    """Ordered lock acquisition (ascending shard ids) + planned-shard
    discipline: concurrent cross-shard moves/kills/submits interleave
    without deadlock and every job ends owned by exactly one shard."""
    store, txn, router, pools = plane(P)
    n = 24
    txn.commit("jobs/submit", {"jobs": [
        job(P, f"c{i:02d}", pools[i % 4]) for i in range(n)]})
    errors = []

    def mover(offset):
        try:
            for i in range(offset, n, 2):
                txn.commit("job/pool-move",
                           {"uuid": f"c{i:02d}",
                            "pool": pools[(i + offset + 1) % 4]})
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    def killer():
        try:
            txn.commit("jobs/kill",
                       {"uuids": [f"c{i:02d}" for i in range(0, n, 3)]})
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=mover, args=(0,)),
               threading.Thread(target=mover, args=(1,)),
               threading.Thread(target=killer)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive(), "cross-shard commit deadlocked"
    assert not errors, errors
    assert len(store.jobs) == n
    for i in range(n):
        owners = [s.shard_id for s in store.shards
                  if f"c{i:02d}" in s.jobs]
        assert len(owners) == 1, (i, owners)
        owner_pool = store.jobs[f"c{i:02d}"].pool
        assert router.shard_for_pool(owner_pool) == owners[0]


@PKGS
def test_cross_shard_kill_and_user_views(P):
    store, txn, _, pools = plane(P)
    batch = [job(P, f"k{i}", pools[i % 4], user="killer") for i in range(4)]
    txn.commit("jobs/submit", {"jobs": batch})
    outcome = txn.commit("jobs/kill",
                         {"uuids": [f"k{i}" for i in range(4)]})
    assert sorted(outcome.result["killed"]) == [f"k{i}" for i in range(4)]
    assert all(j.state is P.ent.JobState.COMPLETED
               for j in store.user_jobs("killer"))
    assert len(outcome.shard_seqs) == 4


def test_shard_view_feeds_the_contention_observatory():
    """A sharded pipeline's per-shard rows reach /debug/contention
    through `ContentionObservatory.shards_fn` (the REST layer wires it
    when its txn has `shard_view`)."""
    from cook_tpu_torch.rest.api import ApiConfig, CookApi

    store, txn, router, pools = plane(PORT, n_shards=2)
    txn.commit("jobs/submit", {"jobs": [job(PORT, "v0", pools[0]),
                                        job(PORT, "v1", pools[1])]})
    api = CookApi(store, None, ApiConfig(), txn=txn)
    rows = api.contention.shards_fn()
    assert [r["shard"] for r in rows] == [0, 1]
    assert [r["jobs"] for r in rows] == [1, 1]
    assert rows[1]["last_seq"] == store.shards[1].last_seq()


# ---------------------------------------------------------------- segments


def build_plane(P, tmp_path, n_shards=4):
    store = P.shard.ShardedStore(n_shards)
    pools = store.router.pools_for_distinct_shards()
    journals = P.journal.attach_shard_journals(store, str(tmp_path))
    for name in pools:
        store.set_pool(P.ent.Pool(name=name))
    txn = P.shard.ShardedTransactionLog(store, journals=journals)
    return store, txn, journals, pools


@PKGS
def test_sharded_recovery_replays_each_segment(P, tmp_path):
    store, txn, journals, pools = build_plane(P, tmp_path)
    for i in range(8):
        txn.commit("jobs/submit", {"jobs": [job(P, f"d{i}", pools[i % 4])]})
    store.create_instance("d0", "t0", hostname="h0")
    store.update_instance_state("t0", P.ent.InstanceStatus.SUCCESS)
    for journal in journals:
        journal.close()
    recovered = P.journal.recover_sharded(str(tmp_path), 4)
    assert recovered is not None
    assert len(recovered.jobs) == 8
    assert recovered.jobs["d3"].pool == pools[3]
    assert recovered.job_instances("d0")[0].status is \
        P.ent.InstanceStatus.SUCCESS
    # per-shard sequence numbering survives (replication resumes from
    # each shard's own head)
    assert recovered.last_seqs() == store.last_seqs()
    # idempotency tables recovered per shard: a replayed commit dedupes
    outcome = P.shard.ShardedTransactionLog(recovered).commit(
        "jobs/submit", {"jobs": [job(P, "d0", pools[0])]},
        txn_id=next(iter(store.shards[0].txn_results)))
    assert outcome.duplicate


@PKGS
def test_cross_shard_move_survives_per_segment_replay(P, tmp_path):
    store, txn, journals, pools = build_plane(P, tmp_path)
    txn.commit("jobs/submit", {"jobs": [job(P, "mv", pools[0])]})
    txn.commit("job/pool-move", {"uuid": "mv", "pool": pools[3]})
    for journal in journals:
        journal.close()
    recovered = P.journal.recover_sharded(str(tmp_path), 4)
    router = recovered.router
    src = recovered.shards[router.shard_for_pool(pools[0])]
    dst = recovered.shards[router.shard_for_pool(pools[3])]
    # the source segment's shard-out replayed (no duplicate ownership)
    assert "mv" not in src.jobs
    assert dst.jobs["mv"].pool == pools[3]
    assert len(recovered.jobs) == 1


@PKGS
def test_snapshot_sharded_plus_suffix(P, tmp_path):
    store, txn, journals, pools = build_plane(P, tmp_path)
    txn.commit("jobs/submit", {"jobs": [job(P, "pre", pools[1])]})
    P.journal.snapshot_sharded(store, str(tmp_path))
    for journal in journals:
        journal.rotate()
    txn.commit("jobs/submit", {"jobs": [job(P, "post", pools[1])]})
    for journal in journals:
        journal.close()
    recovered = P.journal.recover_sharded(str(tmp_path), 4)
    assert set(recovered.jobs.keys()) == {"pre", "post"}


@PKGS
def test_recover_uses_on_disk_shard_count(P, tmp_path):
    store, txn, journals, pools = build_plane(P, tmp_path, n_shards=4)
    txn.commit("jobs/submit", {"jobs": [job(P, "a", pools[0])]})
    for journal in journals:
        journal.close()
    # a misconfigured node asking for 8 shards still recovers the
    # 4-shard layout (resharding is a migration, not a config edit)
    recovered = P.journal.recover_sharded(str(tmp_path), 8)
    assert recovered.n_shards == 4
    assert "a" in recovered.jobs


def make_single_layout(P, tmp_path, n_jobs=10):
    store = P.store.JobStore()
    journal = P.persist.attach_journal(
        store, os.path.join(str(tmp_path), "journal.jsonl"))
    pools = P.shard.ShardRouter(4).pools_for_distinct_shards()
    for name in pools:
        store.set_pool(P.ent.Pool(name=name))
    store.submit_jobs([job(P, f"m{i:02d}", pools[i % 4])
                       for i in range(n_jobs)])
    store.create_instance("m00", "mt0", hostname="h0")
    store.note_txn("txn-old", "jobs/submit", {"jobs": ["m00"]})
    journal.close()
    return store, pools


@PKGS
def test_migration_round_trip_and_idempotence(P, tmp_path):
    source, pools = make_single_layout(P, tmp_path)
    first = P.journal.migrate_single_journal(str(tmp_path), 4)
    assert first["migrated"] and first["jobs"] == 10
    assert sum(first["per_shard_jobs"]) == 10
    # exactly-once: the manifest marks the dir sharded
    again = P.journal.migrate_single_journal(str(tmp_path), 4)
    assert not again["migrated"]
    assert again["reason"] == "already-sharded"
    # originals renamed, never replayed by an unsharded recover
    assert os.path.exists(
        os.path.join(str(tmp_path), "journal.jsonl.premigrate"))
    assert P.persist.recover(str(tmp_path)) is None
    recovered = P.journal.recover_sharded(str(tmp_path), 4)
    assert set(recovered.jobs.keys()) == set(source.jobs.keys())
    assert recovered.jobs["m03"].pool == source.jobs["m03"].pool
    assert recovered.job_instances("m00")[0].task_id == "mt0"
    assert set(recovered.pools) == set(pools)
    # submission-order tie-break survives per shard
    shard = recovered.shard_of_job("m00")
    same_shard = sorted((u for u in source.jobs
                         if shard.jobs.get(u) is not None),
                        key=lambda u: source.job_seq[u])
    assert sorted(shard.job_seq, key=lambda u: shard.job_seq[u]) == \
        same_shard
    # the idempotency table migrated to every shard
    txn = P.shard.ShardedTransactionLog(recovered)
    assert txn.commit("jobs/submit", {"jobs": [job(P, "m00", pools[0])]},
                      txn_id="txn-old").duplicate


@PKGS
def test_migration_of_fresh_dir_stamps_manifest(P, tmp_path):
    outcome = P.journal.migrate_single_journal(str(tmp_path), 4)
    assert outcome["reason"] == "fresh"
    manifest = P.journal.read_manifest(str(tmp_path))
    assert manifest["shards"] == 4
    assert not P.journal.has_single_journal_layout(str(tmp_path))


@PKGS
def test_migration_rejects_single_shard_target(P, tmp_path):
    with pytest.raises(ValueError):
        P.journal.migrate_single_journal(str(tmp_path), 1)


# --------------------------------------------------------- across packages


def _write_sharded_history(P, tmp_path, n_shards=2):
    """Submits on both shards (one of them cross-shard), a launch, a
    success, a kill, a share, and a cross-shard pool move of a job whose
    failed instance moves with it (`instance/shard-in`), journaled in
    per-shard segments."""
    e = P.ent
    store, txn, journals, pools = build_plane(P, tmp_path, n_shards)
    txn.commit("jobs/submit", {"jobs": [
        job(P, f"x{i}", pools[i % n_shards], user=f"u{i % 3}",
            max_retries=3)
        for i in range(8)]}, txn_id="submit-x")
    txn.commit("jobs/submit", {"jobs": [job(P, "solo", pools[1])]},
               txn_id="submit-solo")
    store.create_instance("x0", "t-x0", hostname="h0")
    store.update_instance_state("t-x0", e.InstanceStatus.SUCCESS)
    store.create_instance("x1", "t-x1", hostname="h1")
    txn.commit("share/set", {"share": e.Share(
        user="u1", pool=pools[1], resources=e.Resources(mem=10, cpus=1))},
        txn_id="share-1")
    txn.commit("jobs/kill", {"uuids": ["x2", "x3"]}, txn_id="kill-1")
    store.create_instance("x4", "t-x4", hostname="h2")
    store.update_instance_state("t-x4", e.InstanceStatus.FAILED)
    assert store.jobs["x4"].state is e.JobState.WAITING
    moved = txn.commit("job/pool-move", {"uuid": "x4", "pool": pools[1]},
                       txn_id="move-1")
    assert moved.result["moved"] and len(moved.shard_seqs) == 2
    dst = store.shards[store.router.shard_for_pool(pools[1])]
    assert "t-x4" in dst.instances
    assert "instance/shard-in" in [ev.kind for ev in dst.events_since(0)]
    return store, journals, pools


@PAIRS
def test_sharded_data_dir_recovers_across_packages(W, R, tmp_path):
    """A sharded data_dir written by one package (a cross-shard move
    among its commits) recovers in the other, shard for shard, with
    equal per-shard `snapshot_state`; after a sharded snapshot and a
    suffix too."""
    store, journals, pools = _write_sharded_history(W, tmp_path)
    W.journal.snapshot_sharded(store, str(tmp_path))
    for journal in journals:
        journal.rotate()
    W.shard.ShardedTransactionLog(store, journals=journals).commit(
        "jobs/submit", {"jobs": [job(W, "late", pools[0])]})
    for journal in journals:
        journal.close()
    recovered = R.journal.recover_sharded(str(tmp_path), 2)
    assert recovered.last_seqs() == store.last_seqs()
    assert shard_states(R, recovered) == shard_states(W, store)
    dst = recovered.shards[recovered.router.shard_for_pool(pools[1])]
    assert dst.jobs["x4"].pool == pools[1]
    assert [i.task_id for i in recovered.job_instances("x4")] == ["t-x4"]
    assert "t-x4" in dst.instances


@PAIRS
def test_migration_reads_across_packages(W, R, tmp_path):
    """A single-journal data_dir migrated by one package recovers in the
    other with the per-shard state of the migrating package's own
    recovery."""
    make_single_layout(W, tmp_path)
    W.journal.migrate_single_journal(str(tmp_path), 4)
    mine = W.journal.recover_sharded(str(tmp_path), 4)
    theirs = R.journal.recover_sharded(str(tmp_path), 4)
    assert shard_states(R, theirs) == shard_states(W, mine)
    # the migration is read as done: the other package does not redo it
    assert R.journal.migrate_single_journal(str(tmp_path), 4)[
        "reason"] == "already-sharded"


def _post(url, path, body):
    r = requests.post(f"{url}{path}", json=body, headers=ADMIN,
                      timeout=TIMEOUT_S)
    assert r.status_code in (200, 201), r.text
    return r.json()


@PAIRS
def test_sharded_follower_tails_the_other_package(W, R, tmp_path):
    """A sharded follower of package R tails a 2-shard leader of package
    W — cross-shard submits, a cross-shard move and a kill — each shard
    on its own `?shard=i` feed, to per-shard snapshots equal to the
    leader's."""
    leader = W.server.InprocessControlPlane(
        shards=2, pools=tuple(W.shard.ShardRouter(2)
                              .pools_for_distinct_shards()),
        data_dir=str(tmp_path / "leader")).start()
    store2 = R.shard.ShardedStore(2)
    follower = R.replica.ShardedJournalFollower(
        store2, leader_url_fn=lambda: leader.url,
        self_url="http://replica", member_id="replica",
        poll_s=0.05, timeout_s=2.0, long_poll_s=0.5).start()
    try:
        pools = sorted(leader.store.pools)
        body = _post(leader.url, "/jobs", {"jobs": [
            {"uuid": f"00000000-0000-0000-0000-00000000000{i}",
             "command": "true", "mem": 64, "cpus": 0.5,
             "pool": pools[i % 2]} for i in range(6)]})
        uuids = body["jobs"]
        _post(leader.url, "/pool-move", {"job": uuids[0],
                                          "pool": pools[1]})
        r = requests.delete(f"{leader.url}/jobs", params={"job": uuids[1]},
                            headers=ADMIN, timeout=TIMEOUT_S)
        assert r.status_code == 204, r.text
        deadline = time.monotonic() + TIMEOUT_S
        while store2.last_seqs() != leader.store.last_seqs():
            assert time.monotonic() < deadline, (
                store2.last_seqs(), leader.store.last_seqs())
            time.sleep(0.05)
        assert shard_states(R, store2) == shard_states(W, leader.store)
        assert store2.shard_of_job(uuids[0]).jobs[uuids[0]].pool == pools[1]
    finally:
        follower.stop()
        leader.stop()


# ------------------------------------------ a standby's resync (port only)


@pytest.mark.parametrize("case", ["two-resyncs", "resync-beside-live-apply"])
def test_sharded_standby_resyncs_with_a_scheduler_attached(case):
    """A port standby with a Scheduler on its 2-shard store (the columnar
    index's rebuild, a resync listener of every shard, reads every
    shard). A leader incarnation change sends both shard followers
    through `_full_resync`, and listeners registered ahead of the
    Scheduler's make the resyncs meet at their worst: both shards'
    restores at once (`two-resyncs`), or shard 0's while shard 1's
    follower applies a live event under its shard lock
    (`resync-beside-live-apply`). The standby must reach the leader's
    head on both shards, with its index consistent, within the join
    timeout. The reference's columnar rebuild takes the index lock before
    the shards' and deadlocks here (ROADMAP Queue C)."""
    from cook_tpu_torch.cluster import mock as port_mock
    from cook_tpu_torch.scheduler import core as port_core
    from cook_tpu_torch.scheduler import matcher as port_matcher

    pools = port_router.ShardRouter(2).pools_for_distinct_shards()
    marker = "00000000-0000-0000-0000-0000000000ff"
    leader = port_server.InprocessControlPlane(
        shards=2, pools=tuple(pools)).start()
    store = port_shard.ShardedStore(2)
    armed, entered0 = threading.Event(), threading.Event()
    live_in, resync_in = threading.Event(), threading.Event()
    meet = threading.Barrier(2, timeout=TIMEOUT_S)

    def gate(i):
        def listener():
            if not armed.is_set():
                return
            if case == "two-resyncs":
                meet.wait()
            elif i == 0 and not entered0.is_set():
                entered0.set()
                live_in.wait(TIMEOUT_S)
                resync_in.set()
        return listener

    def live(event):
        if (case == "resync-beside-live-apply"
                and event.kind == "job/created"
                and event.data.get("uuid") == marker):
            live_in.set()
            resync_in.wait(TIMEOUT_S)
            time.sleep(0.2)  # the resync reaches its rebuild meanwhile

    for i, shard in enumerate(store.shards):
        shard.add_resync_listener(gate(i))
    store.shards[1].add_watcher(live)
    assert store.router.shard_for_pool(pools[1]) == 1
    cluster = port_mock.MockCluster("c", [port_mock.MockHost(
        node_id="h0", hostname="h0", mem=8000, cpus=16)],
        clock=store.clock)
    scheduler = port_core.Scheduler(store, [cluster], port_core.SchedulerConfig(
        match=port_matcher.MatchConfig(chunk=0)), device="cpu")
    follower = port_replica.ShardedJournalFollower(
        store, leader_url_fn=lambda: leader.url, self_url="http://replica",
        member_id="replica", poll_s=0.05, timeout_s=2.0,
        long_poll_s=0.5).start()

    def within(what, fn):
        # a deadlocked store blocks its readers too (`last_seq` takes the
        # shard lock), so every wait runs on a thread joined with a timeout
        out = {}
        waiter = threading.Thread(target=lambda: out.update(value=fn()),
                                  daemon=True)
        waiter.start()
        waiter.join(TIMEOUT_S)
        assert not waiter.is_alive(), f"{what}: blocked for good"
        return out.get("value")

    def caught_up(resyncs):
        deadline = time.monotonic() + TIMEOUT_S - 1
        while (store.last_seqs() != leader.store.last_seqs()
               or follower.full_resyncs < resyncs):
            if time.monotonic() > deadline:
                return False
            time.sleep(0.05)
        return True

    def submit(uuids_pools):
        _post(leader.url, "/jobs", {"jobs": [
            {"uuid": u, "command": "true", "mem": 64, "cpus": 0.5,
             "pool": pool} for u, pool in uuids_pools]})

    try:
        submit([(f"00000000-0000-0000-0000-00000000000{i}", pools[i % 2])
                for i in range(4)])
        assert within("the first sync", lambda: caught_up(0))
        armed.set()
        leader.api.incarnation = "resync-" + case
        if case == "resync-beside-live-apply":
            # shard 0's restore waits in its listener, shard 1's is done
            deadline = time.monotonic() + TIMEOUT_S
            while not (entered0.is_set()
                       and follower.followers[1].full_resyncs):
                assert time.monotonic() < deadline, "no resync began"
                time.sleep(0.02)
            submit([(marker, pools[1])])
        assert within("the resyncs", lambda: caught_up(2))
        assert within("the index check",
                      scheduler.columnar.consistent_with_store)
        assert [f.full_resyncs for f in follower.followers] == [1, 1]
        assert shard_states(PORT, store) == shard_states(PORT, leader.store)
    finally:
        follower.stop()
        leader.stop()
