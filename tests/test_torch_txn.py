"""The commit pipeline and the journal of `cook_tpu_torch` against
`cook_tpu` on the CPU: the pipeline the elastic planner commits through.

- The three `TransactionLog` units of tests/test_txn_durability.py
  (:259, :288, :302): a duplicate answered from the transaction table
  (and again after journal replay), the snapshot carrying the table,
  bounded transient retries.
- The ten cases of tests/test_persistence.py: the snapshot round trip,
  the journal's event kinds, snapshot plus new events, rotation,
  journal-only recovery, snapshot plus journal suffix, a torn tail, an
  empty directory, the torn tail repaired before reattaching, and the
  writer's batched fsync and group sync.
- State carried across: a journal written by either package (loans, a
  reclaim, a share, a submit, and more) recovers in the other with an
  equal ledger, transaction table, jobs, instances and shares, and a
  snapshot likewise; the two packages write the same journal lines.

Each case runs on both packages (`ref` / `port`) with the reference's
assertions."""
import json
from types import SimpleNamespace

import pytest
import torch

from cook_tpu import faults as ref_faults
from cook_tpu import txn as ref_txn
from cook_tpu.models import entities as ref_ent
from cook_tpu.models import persistence as ref_persist
from cook_tpu.models import store as ref_store
from cook_tpu_torch import faults as port_faults
from cook_tpu_torch import txn as port_txn
from cook_tpu_torch.models import entities as port_ent
from cook_tpu_torch.models import persistence as port_persist
from cook_tpu_torch.models import store as port_store
from tests.conftest import FakeClock

# one intra-op thread: the suite runs several pytest-xdist workers side
# by side, and idle OpenMP threads spinning in each would crowd them
torch.set_num_threads(1)

REF = SimpleNamespace(name="ref", ent=ref_ent, store=ref_store,
                      persist=ref_persist, txn=ref_txn, faults=ref_faults)
PORT = SimpleNamespace(name="port", ent=port_ent, store=port_store,
                       persist=port_persist, txn=port_txn,
                       faults=port_faults)
PKGS = pytest.mark.parametrize("P", [REF, PORT], ids=["ref", "port"])
PAIRS = pytest.mark.parametrize(
    "W,R", [(REF, PORT), (PORT, REF)], ids=["ref-to-port", "port-to-ref"])


def make_job(P, user="alice", pool="default", mem=100.0, cpus=1.0,
             uuid=None, **kw):
    e = P.ent
    kw.setdefault("max_retries", 1)
    return e.Job(uuid=uuid or e.new_uuid(), user=user, pool=pool,
                 priority=50,
                 resources=e.Resources(mem=mem, cpus=cpus),
                 command="true", **kw)


# --------------------------------------------------- TransactionLog units


@PKGS
def test_txn_log_duplicate_answered_from_table(P, tmp_path):
    store = P.store.JobStore()
    store.set_pool(P.ent.Pool(name="default"))
    journal = P.persist.attach_journal(store,
                                       str(tmp_path / "journal.jsonl"))
    txn = P.txn.TransactionLog(store, journal=journal)
    share = P.ent.Share(user="u", pool="default",
                        resources=P.ent.Resources(mem=5.0, cpus=1.0))
    out = txn.commit("share/set", {"share": share}, txn_id="t1")
    assert not out.duplicate and out.seq == store.last_seq()
    seq = store.last_seq()
    dup = txn.commit("share/set", {"share": share}, txn_id="t1")
    assert dup.duplicate is True
    assert dup.seq == out.seq and dup.result == out.result
    assert store.last_seq() == seq, "duplicate re-applied"
    journal.close()
    entries = P.persist.read_journal(str(tmp_path / "journal.jsonl"))
    cold = P.store.JobStore()
    P.persist.apply_journal(cold, entries)
    assert "t1" in cold.txn_results
    dup2 = P.txn.TransactionLog(cold).commit("share/set", {"share": share},
                                             txn_id="t1")
    assert dup2.duplicate is True
    assert cold.shares[("u", "default")].resources.mem == 5.0


@PKGS
def test_txn_log_snapshot_carries_table(P):
    src = P.store.JobStore()
    src.set_pool(P.ent.Pool(name="default"))
    P.txn.TransactionLog(src).commit("config/update",
                                     {"updates": {"a": 1}}, txn_id="t-cfg")
    state = P.persist.snapshot_state(src)
    dst = P.store.JobStore()
    resyncs = []
    dst.add_resync_listener(lambda: resyncs.append(1))
    P.persist.restore_into(dst, state)
    assert resyncs == [1]
    assert "t-cfg" in dst.txn_results
    assert P.txn.TransactionLog(dst).commit(
        "config/update", {"updates": {"a": 1}},
        txn_id="t-cfg").duplicate is True


@PKGS
def test_txn_log_bounded_transient_retries(P):
    calls = {"n": 0}

    @P.txn.txn_op("test/flaky")
    def _flaky(store, payload):
        calls["n"] += 1
        if calls["n"] < 3:
            raise P.txn.TransientTxnError("not yet")
        return {"ok": True}

    try:
        store = P.store.JobStore()
        txn = P.txn.TransactionLog(store, policy=P.txn.DurabilityPolicy(
            max_attempts=3, retry_backoff_s=0.0))
        out = txn.commit("test/flaky", {})
        assert out.attempts == 3 and out.result == {"ok": True}
        calls["n"] = -100  # always transient within the budget
        with pytest.raises(P.txn.TransientTxnError):
            txn.commit("test/flaky", {})
        with pytest.raises(P.txn.UnknownOperation):
            txn.commit("test/no-such-op", {})
    finally:
        del P.txn.OPS["test/flaky"]


def test_port_registers_every_reference_op():
    assert sorted(port_txn.OPS) == sorted(ref_txn.OPS)


# ---------------------------------------------------- tests/test_persistence


def populated_store(P, clock):
    e = P.ent
    store = P.store.JobStore(clock=clock)
    store.set_pool(e.Pool(name="default"))
    store.set_share(e.Share(user="default", pool="default",
                            resources=e.Resources(mem=1000, cpus=10,
                                                  gpus=1)))
    store.set_quota(e.Quota(user="alice", pool="default",
                            resources=e.Resources(mem=float("inf"),
                                                  cpus=50),
                            count=10))
    j1 = make_job(P, user="alice",
                  checkpoint=e.Checkpoint(mode="auto", location="us-east"),
                  application=e.Application(name="svc", version="1.2",
                                            workload_class="batch",
                                            workload_id="w-17"))
    j2 = make_job(P, user="bob", max_retries=3)
    j3 = make_job(P, user="bob")
    store.submit_jobs([j1, j2, j3])
    store.create_instance(j1.uuid, "t1", hostname="h1", compute_cluster="c")
    store.update_instance_state("t1", e.InstanceStatus.RUNNING)
    store.create_instance(j2.uuid, "t2", hostname="h2")
    store.update_instance_state("t2", e.InstanceStatus.FAILED, 1002)
    store.dynamic_config["x"] = {"y": 1}
    return store, (j1, j2, j3)


@PKGS
def test_snapshot_roundtrip(P, tmp_path):
    clock = FakeClock()
    store, (j1, j2, j3) = populated_store(P, clock)
    path = str(tmp_path / "snap.json")
    P.persist.snapshot(store, path)
    restored = P.persist.load_snapshot(path, clock=clock)
    assert restored.jobs.keys() == store.jobs.keys()
    for uuid in store.jobs:
        assert restored.jobs[uuid] == store.jobs[uuid], uuid
    assert restored.instances == store.instances
    assert restored.get_share("anyone", "default").mem == 1000
    assert restored.get_quota("alice", "default").count == 10
    assert restored.dynamic_config == {"x": {"y": 1}}
    assert {j.uuid for j in restored.pending_jobs("default")} == {
        j2.uuid, j3.uuid}
    assert [j.uuid for j in restored.running_jobs("default")] == [j1.uuid]
    restored.update_instance_state("t1", P.ent.InstanceStatus.SUCCESS, 1000)
    assert restored.jobs[j1.uuid].state == P.ent.JobState.COMPLETED
    assert restored.jobs[j1.uuid].application \
        == store.jobs[j1.uuid].application
    assert restored.jobs[j1.uuid].application.workload_id == "w-17"


@PKGS
def test_journal_appends_events(P, tmp_path):
    store = P.store.JobStore(clock=FakeClock())
    store.set_pool(P.ent.Pool(name="default"))
    jpath = str(tmp_path / "journal.jsonl")
    writer = P.persist.attach_journal(store, jpath)
    job = make_job(P)
    store.submit_jobs([job])
    store.create_instance(job.uuid, "t1", hostname="h1")
    store.update_instance_state("t1", P.ent.InstanceStatus.SUCCESS, 1000)
    writer.close()
    events = P.persist.read_journal(jpath)
    kinds = [e["kind"] for e in events]
    assert kinds == ["job/created", "instance/created", "job/state",
                     "instance/status", "job/state"]
    seqs = [e["seq"] for e in events]
    assert seqs == sorted(seqs) and len(set(seqs)) == len(seqs)


@PKGS
def test_snapshot_plus_new_events(P, tmp_path):
    clock = FakeClock()
    store, (j1, j2, j3) = populated_store(P, clock)
    snap = str(tmp_path / "snap.json")
    P.persist.snapshot(store, snap)
    restored = P.persist.load_snapshot(snap, clock=clock)
    seen = []
    restored.add_watcher(lambda e: seen.append(e))
    restored.kill_jobs([j3.uuid])
    old_last = store.snapshot_events()[-1].seq
    assert seen[0].seq == old_last + 1


@PKGS
def test_journal_rotation(P, tmp_path):
    clock = FakeClock()
    store = P.store.JobStore(clock=clock)
    store.set_pool(P.ent.Pool(name="default"))
    jpath = str(tmp_path / "j.jsonl")
    writer = P.persist.attach_journal(store, jpath)
    store.submit_jobs([make_job(P)])
    assert P.persist.read_journal(jpath)
    P.persist.snapshot(store, str(tmp_path / "snap.json"))
    writer.rotate()
    assert P.persist.read_journal(jpath) == []
    assert P.persist.read_journal(jpath + ".1")
    store.submit_jobs([make_job(P)])
    events = P.persist.read_journal(jpath)
    assert events and events[0]["kind"] == "job/created"
    writer.close()
    restored = P.persist.load_snapshot(str(tmp_path / "snap.json"),
                                       clock=clock)
    assert len(restored.jobs) == 1


def _same_state(a, b) -> None:
    """Stores equal across packages: entities compare by their codec
    encoding (each package has its own entity classes)."""
    from cook_tpu_torch.models import codec

    def enc(d):
        return {k: codec.encode(v) for k, v in d.items()}

    assert enc(b.jobs) == enc(a.jobs)
    assert enc(b.instances) == enc(a.instances)
    assert enc(b.groups) == enc(a.groups)
    assert enc(b.pools) == enc(a.pools)
    assert enc(b.shares) == enc(a.shares)
    assert enc(b.quotas) == enc(a.quotas)
    assert b.dynamic_config == a.dynamic_config
    assert b.capacity_ledger == a.capacity_ledger
    assert b.txn_results == a.txn_results
    for pool in a.pools:
        assert ({j.uuid for j in b.pending_jobs(pool)}
                == {j.uuid for j in a.pending_jobs(pool)})
        assert ({j.uuid for j in b.running_jobs(pool)}
                == {j.uuid for j in a.running_jobs(pool)})


@PKGS
def test_recover_journal_only(P, tmp_path):
    e = P.ent
    clock = FakeClock()
    store = P.store.JobStore(clock=clock)
    writer = P.persist.attach_journal(store, str(tmp_path / "journal.jsonl"))
    store.set_pool(e.Pool(name="default"))
    store.set_share(e.Share(user="default", pool="default",
                            resources=e.Resources(mem=500, cpus=4, gpus=0)))
    store.set_quota(e.Quota(user="alice", pool="default",
                            resources=e.Resources(mem=1e9, cpus=100),
                            count=7))
    j1 = make_job(P, user="alice",
                  application=e.Application(name="a", version="2"))
    j2 = make_job(P, user="bob")
    store.submit_jobs([j1, j2])
    store.create_instance(j1.uuid, "t1", hostname="h1")
    store.update_instance_state("t1", e.InstanceStatus.RUNNING)
    store.update_instance_progress("t1", 40, "halfway-ish")
    store.set_instance_output("t1", exit_code=None, sandbox_directory="/sb")
    store.update_dynamic_config({"rebalancer": {"max_preemption": 9}})
    store.retract_quota("alice", "default")
    writer.close()
    restored = P.persist.recover(str(tmp_path), clock=clock)
    assert restored is not None
    _same_state(store, restored)
    assert restored.jobs[j1.uuid].application.name == "a"
    assert restored.instances["t1"].progress == 40
    assert restored.instances["t1"].sandbox_directory == "/sb"
    assert ("alice", "default") not in restored.quotas
    assert restored.last_seq() == store.last_seq()
    restored.kill_jobs([j2.uuid])
    assert restored.last_seq() == store.last_seq() + 1


@PKGS
def test_recover_snapshot_plus_journal_suffix(P, tmp_path):
    clock = FakeClock()
    store = P.store.JobStore(clock=clock)
    writer = P.persist.attach_journal(store, str(tmp_path / "journal.jsonl"))
    store.set_pool(P.ent.Pool(name="default"))
    j1 = make_job(P, user="alice")
    store.submit_jobs([j1])
    P.persist.snapshot(store, str(tmp_path / "snapshot.json"))
    writer.rotate()
    j2 = make_job(P, user="bob", group_uuid=None)
    store.submit_jobs([j2])
    store.create_instance(j1.uuid, "t1", hostname="h1")
    store.update_instance_state("t1", P.ent.InstanceStatus.RUNNING)
    store.update_instance_state("t1", P.ent.InstanceStatus.SUCCESS, 1000)
    store.retry_job(j2.uuid, 5)
    writer.close()
    restored = P.persist.recover(str(tmp_path), clock=clock)
    _same_state(store, restored)
    assert restored.jobs[j1.uuid].state == P.ent.JobState.COMPLETED
    assert restored.jobs[j2.uuid].max_retries == 5
    assert restored.recovered_stats["journal_replayed"] > 0


@PKGS
def test_recover_tolerates_torn_tail(P, tmp_path):
    clock = FakeClock()
    store = P.store.JobStore(clock=clock)
    writer = P.persist.attach_journal(store, str(tmp_path / "journal.jsonl"))
    store.set_pool(P.ent.Pool(name="default"))
    j1 = make_job(P)
    store.submit_jobs([j1])
    writer.close()
    with open(tmp_path / "journal.jsonl", "a") as f:
        f.write('{"seq": 99, "kind": "job/created", "da')
    restored = P.persist.recover(str(tmp_path), clock=clock)
    assert j1.uuid in restored.jobs


@PKGS
def test_recover_empty_dir_returns_none(P, tmp_path):
    assert P.persist.recover(str(tmp_path), clock=FakeClock()) is None


@PKGS
def test_torn_tail_repaired_before_reattach(P, tmp_path):
    clock = FakeClock()
    jpath = str(tmp_path / "journal.jsonl")
    store = P.store.JobStore(clock=clock)
    writer = P.persist.attach_journal(store, jpath)
    store.set_pool(P.ent.Pool(name="default"))
    j1 = make_job(P)
    store.submit_jobs([j1])
    writer.close()
    with open(jpath, "a") as f:
        f.write('{"seq": 77, "kind": "job/created", "da')
    store2 = P.persist.recover(str(tmp_path), clock=clock)
    writer2 = P.persist.attach_journal(store2, jpath)
    j2 = make_job(P, user="bob")
    store2.submit_jobs([j2])
    writer2.close()
    store3 = P.persist.recover(str(tmp_path), clock=clock)
    assert j1.uuid in store3.jobs
    assert j2.uuid in store3.jobs


@PKGS
def test_journal_writer_batched_fsync_default_and_group_sync(P, tmp_path):
    jpath = str(tmp_path / "journal.jsonl")
    writer = P.persist.JournalWriter(jpath)
    assert writer.fsync_every > 0, "default journal never fsyncs"
    writer.write_line(json.dumps({"seq": 1, "kind": "x", "data": {}}))
    assert writer._dirty
    writer.sync()
    assert not writer._dirty, "sync() left flushed events unfsynced"
    writer.sync()
    batched = P.persist.JournalWriter(str(tmp_path / "j2.jsonl"),
                                      fsync_every=2)
    batched.write_line(json.dumps({"seq": 1, "kind": "x", "data": {}}))
    assert batched._dirty
    batched.write_line(json.dumps({"seq": 2, "kind": "x", "data": {}}))
    assert not batched._dirty
    batched.close()
    writer.close()
    assert [e["seq"] for e in P.persist.read_journal(jpath)] == [1]


@PKGS
def test_journal_fsync_fault_point(P, tmp_path):
    """The `journal.fsync` point (the fault plane the writer checks):
    fail-stop re-raises the injected error, degrade-async keeps
    committing and reports degraded, and the telemetry counts both."""
    with P.faults.injected({"point": "journal.fsync", "mode": "error",
                            "times": 1}) as schedule:
        writer = P.persist.JournalWriter(str(tmp_path / "a.jsonl"))
        writer.write_line(json.dumps({"seq": 1, "kind": "x", "data": {}}))
        with pytest.raises(OSError):
            writer.sync()
        writer.sync()
        assert not writer._dirty
        assert schedule.fired_total(P.faults.JOURNAL_FSYNC) == 1
    assert P.faults.ACTIVE is None
    with P.faults.injected({"point": "journal.fsync", "mode": "error",
                            "times": 1}):
        degraded = P.persist.JournalWriter(str(tmp_path / "b.jsonl"),
                                           fsync_policy="degrade-async")
        degraded.write_line(json.dumps({"seq": 1, "kind": "x", "data": {}}))
        degraded.sync()
        assert degraded.degraded
    with pytest.raises(ValueError):
        P.faults.FaultRule(point="no.such.point")
    writer.close()
    degraded.close()


# ------------------------------------------------------- state carried across


def _write_history(P, data_dir):
    """Loans, a reclaim, a share, a submit, a launch and a config update,
    committed through the pipeline with the journal attached."""
    e = P.ent
    store = P.store.JobStore(clock=FakeClock())
    journal = P.persist.attach_journal(store,
                                       str(data_dir / "journal.jsonl"))
    txn = P.txn.TransactionLog(store, journal=journal)
    for name in ("lender", "borrower", "other"):
        store.set_pool(e.Pool(name=name))
    txn.commit("pool/capacity-delta", {"moves": [
        {"kind": "loan", "from": "lender", "to": "borrower",
         "mem": 2000.0, "cpus": 16.0, "gpus": 1.0},
        {"kind": "loan", "from": "other", "to": "borrower",
         "mem": 512.0, "cpus": 2.5, "gpus": 0.0}]}, txn_id="loan-1")
    txn.commit("pool/capacity-delta", {"moves": [
        {"kind": "reclaim", "from": "lender", "to": "borrower",
         "mem": 500.0, "cpus": 4.0, "gpus": 1.0}]}, txn_id="reclaim-1")
    txn.commit("share/set", {"share": e.Share(
        user="alice", pool="borrower",
        resources=e.Resources(mem=4000.0, cpus=8.0))}, txn_id="share-1")
    jobs = [make_job(P, user="alice", pool="borrower", uuid=f"job-{i}",
                     mem=1024.0, cpus=2.0) for i in range(3)]
    txn.commit("jobs/submit", {"jobs": jobs}, txn_id="submit-1")
    store.create_instance("job-0", "task-0", hostname="h0")
    store.update_instance_state("task-0", e.InstanceStatus.RUNNING)
    txn.commit("config/update", {"updates": {"rebalancer": {
        "max_preemption": 7}}}, txn_id="cfg-1")
    txn.commit("jobs/kill", {"uuids": ["job-2"]}, txn_id="kill-1")
    journal.close()
    return store


@PAIRS
def test_journal_recovers_across_packages(W, R, tmp_path):
    """A journal one package writes recovers in the other: equal ledger,
    transaction table, jobs, instances, shares and config, and the
    recovered store answers a retried commit as a duplicate."""
    store = _write_history(W, tmp_path)
    recovered = R.persist.recover(str(tmp_path))
    _same_state(store, recovered)
    assert recovered.capacity_ledger[("lender", "borrower")] == {
        "mem": 1500.0, "cpus": 12.0, "gpus": 0.0}
    assert recovered.last_seq() == store.last_seq()
    out = R.txn.TransactionLog(recovered).commit(
        "pool/capacity-delta", {"moves": [
            {"kind": "reclaim", "from": "lender", "to": "borrower",
             "mem": 500.0, "cpus": 4.0, "gpus": 1.0}]}, txn_id="reclaim-1")
    assert out.duplicate
    assert recovered.capacity_ledger[("lender", "borrower")]["cpus"] == 12.0


@PAIRS
def test_snapshot_recovers_across_packages(W, R, tmp_path):
    store = _write_history(W, tmp_path)
    W.persist.snapshot(store, str(tmp_path / "snapshot.json"))
    recovered = R.persist.recover(str(tmp_path))
    _same_state(store, recovered)
    assert recovered.recovered_stats["snapshot_seq"] == store.last_seq()
    assert recovered.recovered_stats["journal_replayed"] == 0


def test_packages_write_the_same_journal(tmp_path):
    """Written in turn by each package from the same commits, the two
    journals are the same lines (txn results hold the same values)."""
    lines = {}
    for P in (REF, PORT):
        d = tmp_path / P.name
        d.mkdir()
        _write_history(P, d)
        with open(d / "journal.jsonl") as f:
            lines[P.name] = [json.loads(line) for line in f]
    assert lines["port"] == lines["ref"]
