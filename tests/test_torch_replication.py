"""Hot standbys and journal replication (`cook_tpu_torch/control/
replication.py`, the `/replication/*` routes of `rest/api.py`, the
standby role of `components.py`) against the reference's on the CPU: the
in-process cases of tests/test_leader_election.py and
tests/test_replication_durability.py, each on both packages (`P` over
`ref` / `port`, as tests/test_torch_components.py does).

Two schedulers with separate data directories and nothing shared but the
lease service's address: the standby tails the leader's feed into its own
store and journal, acks durably, and promotes when the lease lapses.
`test_memory_only_follower_ack_does_not_satisfy_sync_ack` pins the
reference fix the port copies (only durable acks count), and
`test_follower_stop_outlasts_a_parked_long_poll` the other one (the
follower's join covers a long-poll)."""
import os
import shutil
import threading
import time
from types import SimpleNamespace

import pytest
import requests
import torch

from cook_tpu import components as ref_components
from cook_tpu.control import lease_server as ref_lease
from cook_tpu.control import replication as ref_replication
from cook_tpu.models import entities as ref_ent
from cook_tpu.models import persistence as ref_persist
from cook_tpu.models import store as ref_store
from cook_tpu.rest import server as ref_server
from cook_tpu.utils import config as ref_config
from cook_tpu_torch import components as port_components
from cook_tpu_torch.control import lease_server as port_lease
from cook_tpu_torch.control import replication as port_replication
from cook_tpu_torch.models import entities as port_ent
from cook_tpu_torch.models import persistence as port_persist
from cook_tpu_torch.models import store as port_store
from cook_tpu_torch.rest import server as port_server
from cook_tpu_torch.utils import config as port_config

torch.set_num_threads(1)

REF = SimpleNamespace(name="ref", components=ref_components, lease=ref_lease,
                      replication=ref_replication, ent=ref_ent,
                      persist=ref_persist, store=ref_store,
                      server=ref_server, config=ref_config, platform={})
PORT = SimpleNamespace(name="port", components=port_components,
                       lease=port_lease, replication=port_replication,
                       ent=port_ent, persist=port_persist, store=port_store,
                       server=port_server, config=port_config,
                       platform={"platform": "cpu"})
PKGS = pytest.mark.parametrize("P", [REF, PORT], ids=["ref", "port"])
H = {"X-Cook-Requesting-User": "u"}
ADMIN = {"X-Cook-Requesting-User": "admin"}
TIMEOUT_S = 15


def settings(P, port, data_dir, lease_url, **kw):
    return P.config.Settings(
        port=port, data_dir=data_dir,
        leader_endpoint=lease_url, leader_ttl_s=3.0,
        clusters=[{"kind": "mock", "name": "m1",
                   "hosts": [{"node_id": "h0", "mem": 4000, "cpus": 8}]}],
        pools=[{"name": "default"}],
        rank_interval_s=3600, match_interval_s=3600,
        **P.platform, **kw)


def make_job(P, user="u"):
    return P.ent.Job(uuid=P.ent.new_uuid(), user=user, pool="default",
                     priority=50, max_retries=1,
                     resources=P.ent.Resources(mem=100.0, cpus=1.0),
                     command="true")


def wait(pred, timeout_s, what):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def submit(url, uuid, timeout=TIMEOUT_S, **extra):
    return requests.post(f"{url}/jobs", json={"jobs": [
        {"command": "x", "mem": 100, "cpus": 1, "uuid": uuid, **extra}]},
        headers=H, timeout=timeout)


class Rig:
    """A lease service and the nodes a test boots on it; `close` stops
    every node, joins every standby thread and stops the service, on
    failure too."""

    def __init__(self, P, tmp_path, lease=True):
        self.P = P
        self.tmp_path = tmp_path
        self.lease = P.lease.LeaseServer().start() if lease else None
        self.nodes = []
        self.threads = []

    def boot(self, name, **kw):
        s = settings(self.P, self.P.server.free_port(),
                     str(self.tmp_path / name),
                     self.lease.url if self.lease else "", **kw)
        p = self.P.components.build_process(s)
        self.nodes.append(p)
        return p, f"http://127.0.0.1:{s.port}"

    def lead(self, name, **kw):
        p, url = self.boot(name, **kw)
        self.P.components.start_leader_duties(p, block=False,
                                              on_loss=lambda: None)
        assert p.is_leader()
        return p, url

    def stand_by(self, name, nudge="", **kw):
        """Boot a standby on its own thread.  `nudge`, a leader's URL:
        commit a config update there, so that the standby's first
        long-poll answers at once instead of parking its full window (a
        caught-up follower acks only after its first poll returns)."""
        p, url = self.boot(name, **kw)
        t = threading.Thread(
            target=self.P.components.start_leader_duties, args=(p,),
            kwargs={"block": False, "on_loss": lambda: None}, daemon=True)
        t.start()
        self.threads.append(t)
        if nudge:
            wait(lambda: p.follower is not None, TIMEOUT_S, "the follower")
            assert requests.post(f"{nudge}/incremental-config",
                                 json={"nudge": name}, headers=ADMIN,
                                 timeout=TIMEOUT_S).status_code == 201
        return p, url, t

    def kill(self, p):
        self.nodes.remove(p)
        self.P.components.shutdown(p)

    def close(self):
        for p in self.nodes:
            self.P.components.shutdown(p)
        for t in self.threads:
            t.join(timeout=TIMEOUT_S)
        if self.lease is not None:
            self.lease.stop()
        assert not any(t.is_alive() for t in self.threads)


@pytest.fixture
def rigs(tmp_path):
    made = []

    def make(P, **kw):
        made.append(Rig(P, tmp_path, **kw))
        return made[-1]
    yield make
    for rig in made:
        rig.close()


# ----------------------------------------------- standby replication/failover


@PKGS
def test_standby_replicates_and_survives_leader_disk_loss(P, rigs):
    """Two schedulers, two data dirs, no shared filesystem; the standby
    replicates over HTTP; the leader dies AND ITS DATA DIR IS DELETED;
    the standby promotes with the full state."""
    rig = rigs(P)
    p1, url1 = rig.lead("node1")
    uuids = [f"f0000000-0000-0000-0000-00000000001{i}" for i in range(3)]
    r = requests.post(f"{url1}/jobs", json={"jobs": [
        {"command": "x", "mem": 100, "cpus": 1, "uuid": u} for u in uuids
    ]}, headers=H, timeout=TIMEOUT_S)
    assert r.status_code == 201
    p2, url2, standby = rig.stand_by("node2")
    wait(lambda: uuids[0] in p2.store.jobs, TIMEOUT_S, "replication")
    # the standby serves the replicated state read-locally
    r = requests.get(f"{url2}/jobs/{uuids[1]}", headers=H,
                     timeout=TIMEOUT_S)
    assert r.status_code == 200
    assert not p2.is_leader()
    extra = "f0000000-0000-0000-0000-0000000000ff"
    assert submit(url1, extra).status_code == 201
    wait(lambda: extra in p2.store.jobs, TIMEOUT_S, "the later write")
    # leader dies; its disk burns
    rig.kill(p1)
    shutil.rmtree(str(rig.tmp_path / "node1"))
    standby.join(timeout=30)
    assert p2.is_leader(), "standby never promoted"
    assert all(u in p2.store.jobs for u in uuids + [extra])
    assert requests.get(f"{url2}/jobs/{extra}", headers=H,
                        timeout=TIMEOUT_S).status_code == 200
    assert requests.get(f"{url2}/debug", timeout=TIMEOUT_S).json()[
        "leader"] is True
    # the standby's own disk carries the state
    recovered = P.persist.recover(str(rig.tmp_path / "node2"))
    assert recovered is not None
    assert all(u in recovered.jobs for u in uuids + [extra])


@PKGS
def test_promoted_standby_schedules_replicated_job_without_new_writes(
        P, rigs):
    """A job that reached the standby ONLY via replication is placed by
    the first rank + match cycles after promotion: the replicated events
    kept the columnar index current."""
    rig = rigs(P)
    uuid = "f0000000-0000-0000-0000-000000000031"
    p1, url1 = rig.lead("n1")
    assert submit(url1, uuid).status_code == 201
    p2, _, standby = rig.stand_by("n2")
    wait(lambda: uuid in p2.store.jobs, TIMEOUT_S, "replication")
    assert p2.scheduler.columnar.consistent_with_store()
    rig.kill(p1)
    standby.join(timeout=30)
    assert p2.is_leader(), "standby never promoted"
    pool = p2.store.pools["default"]
    p2.scheduler.rank_cycle(pool)
    p2.scheduler.match_cycle(pool)
    assert p2.store.jobs[uuid].state == P.ent.JobState.RUNNING
    insts = p2.store.job_instances(uuid)
    assert insts and insts[0].hostname == "h0"


@PKGS
def test_follower_bootstraps_via_snapshot_when_behind_window(P, rigs):
    """A leader recovered from disk has an EMPTY event window but a
    non-zero seq: a fresh follower is told snapshot_required and
    bootstraps through /replication/snapshot."""
    rig = rigs(P)
    uuid = "f0000000-0000-0000-0000-000000000021"
    p1, url1 = rig.lead("node1")
    assert submit(url1, uuid).status_code == 201
    rig.kill(p1)
    p1b, url1b = rig.lead("node1")
    assert uuid in p1b.store.jobs
    assert all(e.kind != "job/created" for e in p1b.store.events_since(0))
    p2, _ = rig.boot("node2")
    follower = P.replication.JournalFollower(
        p2.store, leader_url_fn=lambda: url1b,
        data_dir=str(rig.tmp_path / "node2"), journal=p2.journal)
    follower.sync_once()
    assert follower.full_resyncs == 1
    assert uuid in p2.store.jobs
    assert p2.store.last_seq() == p1b.store.last_seq()
    recovered = P.persist.recover(str(rig.tmp_path / "node2"))
    assert recovered is not None and uuid in recovered.jobs


@PKGS
def test_replication_endpoints_admin_gated(P, rigs):
    rig = rigs(P, lease=False)
    _, url = rig.boot("d")
    for path in ("/replication/journal", "/replication/snapshot"):
        assert requests.get(f"{url}{path}", headers={
            "X-Cook-Requesting-User": "mallory"},
            timeout=TIMEOUT_S).status_code == 403
        assert requests.get(f"{url}{path}", headers=ADMIN,
                            timeout=TIMEOUT_S).status_code == 200
    assert requests.post(f"{url}/replication/ack", json={
        "follower": "f", "seq": 1}, headers=H,
        timeout=TIMEOUT_S).status_code == 403
    assert requests.post(f"{url}/shutdown-leader", headers=H,
                         timeout=TIMEOUT_S).status_code == 403


@PKGS
def test_standby_ack_carries_its_url_and_history(P, rigs):
    """The replication ack names the standby's own REST URL in the
    leader's ack registry (the reference's fleet observatory reads it as
    a peer registration; that observatory's port waits), and the standby
    runs its own metrics history."""
    rig = rigs(P)
    p1, url1 = rig.lead("n1")
    p2, url2, _ = rig.stand_by("n2", nudge=url1)
    wait(lambda: any(m.get("url") == url2
                     for m in list(p1.api.replication_ack_meta.values())),
         TIMEOUT_S, "the standby's url in the leader's ack registry")
    meta = p1.api.replication_ack_meta[p2.member_id]
    assert meta["durable"] is True and meta["shard"] == 0
    assert p2.history is not None


# ------------------------------------------------------------------ sync-ack


@PKGS
def test_sync_ack_submission_durable_on_standby_at_201(P, rigs):
    """In sync-ack mode the job is on the standby, in its store and on
    its disk, the instant the 201 goes out."""
    rig = rigs(P)
    p1, url1 = rig.lead("n1", replication_sync_ack=True,
                        replication_ack_timeout_s=10.0)
    p2, _, _ = rig.stand_by("n2", nudge=url1)
    wait(lambda: p1.api.replication_acks, TIMEOUT_S, "standby acks")
    uuid = "d0000000-0000-0000-0000-000000000001"
    r = submit(url1, uuid)
    assert r.status_code == 201
    assert "replicated" not in r.json(), "ack timeout despite standby"
    assert uuid in p2.store.jobs
    rig.kill(p1)
    recovered = P.persist.recover(str(rig.tmp_path / "n2"))
    assert recovered is not None and uuid in recovered.jobs


@PKGS
def test_sync_ack_timeout_commits_but_reports(P, rigs):
    """No standby at all: the write still commits locally, but the
    response is honest about the durability bound — JSON bodies say
    "replicated": false, a 204 says it in X-Cook-Replicated."""
    rig = rigs(P)
    p, url = rig.lead("n1", replication_sync_ack=True,
                      replication_ack_timeout_s=0.3)
    uuid = "d0000000-0000-0000-0000-000000000002"
    r = submit(url, uuid)
    assert r.status_code == 201
    assert r.json().get("replicated") is False
    assert uuid in p.store.jobs
    r = requests.delete(f"{url}/jobs", params={"job": uuid}, headers=H,
                        timeout=TIMEOUT_S)
    assert r.status_code == 204
    assert r.headers.get("X-Cook-Replicated") == "false"
    r = requests.post(f"{url}/retry", json={"job": uuid, "retries": 3},
                      headers=H, timeout=TIMEOUT_S)
    assert r.status_code == 201 and r.json().get("replicated") is False


# ------------------------------------------------------- divergence handling


@PKGS
def test_follower_ahead_gets_snapshot_required(P, rigs):
    """A follower AHEAD of the leader's history (it outlived a deposed
    leader) is told snapshot_required and converges."""
    rig = rigs(P, lease=False)
    p1, url = rig.boot("n1")
    uuid = "d0000000-0000-0000-0000-000000000003"
    assert submit(url, uuid).status_code == 201
    leader_seq = p1.store.last_seq()
    r = requests.get(
        f"{url}/replication/journal?after_seq={leader_seq + 50}",
        headers=ADMIN, timeout=TIMEOUT_S)
    assert r.status_code == 200
    assert r.json().get("snapshot_required") is True
    diverged = P.store.JobStore()
    diverged.reset_seq(leader_seq + 50)
    follower = P.replication.JournalFollower(diverged,
                                             leader_url_fn=lambda: url)
    follower.sync_once()
    assert follower.full_resyncs == 1
    assert diverged.last_seq() == leader_seq
    assert uuid in diverged.jobs


@PKGS
def test_incarnation_change_forces_snapshot_bootstrap(P, rigs):
    """Two leaders with equal-length but different histories: switching
    the follower between them forces a full resync."""
    rig = rigs(P, lease=False)
    pa, url_a = rig.boot("na")
    pb, url_b = rig.boot("nb")
    for url, uuid in ((url_a, "d0000000-0000-0000-0000-00000000000a"),
                      (url_b, "d0000000-0000-0000-0000-00000000000b")):
        assert submit(url, uuid).status_code == 201
    assert pa.store.last_seq() == pb.store.last_seq()
    store = P.store.JobStore()
    current = {"url": url_a}
    follower = P.replication.JournalFollower(
        store, leader_url_fn=lambda: current["url"], long_poll_s=0.5)
    follower.sync_once()
    assert "d0000000-0000-0000-0000-00000000000a" in store.jobs
    current["url"] = url_b
    follower.sync_once()
    assert follower.full_resyncs >= 1
    assert "d0000000-0000-0000-0000-00000000000b" in store.jobs
    assert "d0000000-0000-0000-0000-00000000000a" not in store.jobs


@PKGS
def test_restore_into_clears_event_window(P):
    src = P.store.JobStore()
    src.set_pool(P.ent.Pool(name="default"))
    src.submit_jobs([make_job(P, user="u")])
    state = P.persist.snapshot_state(src)
    dst = P.store.JobStore()
    dst.set_pool(P.ent.Pool(name="default"))
    dst.submit_jobs([make_job(P, user="w")])  # pre-resync events
    assert dst.events_since(0)
    P.persist.restore_into(dst, state)
    assert dst.events_since(0) == []
    assert dst.last_seq() == src.last_seq()


@PKGS
def test_live_apply_events_enter_window_and_journal(P, tmp_path):
    """Replicated events become ordinary committed events: retained in
    the window and journaled via the watcher fan-out, exactly once."""
    import json

    leader = P.store.JobStore()
    leader.set_pool(P.ent.Pool(name="default"))
    leader.submit_jobs([make_job(P, user="u"), make_job(P, user="v")])
    entries = [json.loads(e.to_json()) for e in leader.events_since(0)]
    standby = P.store.JobStore()
    journal = P.persist.attach_journal(standby,
                                       str(tmp_path / "journal.jsonl"))
    with standby._lock:
        applied = P.persist.apply_journal(standby, entries, live=True)
    assert applied == len(entries)
    assert [e.seq for e in standby.events_since(0)] == \
        [e["seq"] for e in entries]
    journal.close()
    replayed = P.persist.read_journal(str(tmp_path / "journal.jsonl"))
    assert [e["seq"] for e in replayed] == [e["seq"] for e in entries]
    cold = P.store.JobStore()
    P.persist.apply_journal(cold, replayed)
    assert set(cold.jobs) == set(leader.jobs)


# ---------------------------------------------------- ack honesty/liveness


@PKGS
def test_memory_only_follower_ack_does_not_satisfy_sync_ack(P, rigs):
    """A follower with no journal and no data_dir acks durable=false, and
    such an ack must not satisfy the sync-ack bound."""
    rig = rigs(P, lease=False)
    p, url = rig.boot("n1", replication_sync_ack=True,
                      replication_ack_timeout_s=0.5)
    follower = P.replication.JournalFollower(
        P.store.JobStore(), leader_url_fn=lambda: url, poll_s=0.05,
        timeout_s=5.0, long_poll_s=0.5, member_id="mem-only")
    assert not follower.is_durable()
    follower.start()
    try:
        wait(lambda: "mem-only" in p.api.replication_ack_meta, TIMEOUT_S,
             "non-durable ack arrival")
        r = submit(url, "d0000000-0000-0000-0000-000000000010")
        assert r.status_code == 201
        assert r.json().get("replicated") is False
        assert p.api.replication_ack_meta["mem-only"]["durable"] is False
        assert "mem-only" not in p.api.replication_acks
    finally:
        follower.stop()


@PKGS
def test_decommissioned_standby_ack_pruned_from_min_acks(P, rigs):
    """min_acks=2 with one live standby and one decommissioned one: the
    dead one's last ack counts while fresh, and past the liveness window
    it is pruned and the bound is honestly reported unmet."""
    rig = rigs(P)
    p1, url = rig.lead("n1", replication_sync_ack=True,
                       replication_min_acks=2,
                       replication_ack_timeout_s=1.5,
                       replication_ack_liveness_s=1.5)
    rig.stand_by("n2", nudge=url)
    wait(lambda: p1.api.replication_acks, TIMEOUT_S, "live standby acks")
    r = requests.post(f"{url}/replication/ack", json={
        "follower": "ghost", "seq": 10**9, "durable": True},
        headers=ADMIN, timeout=TIMEOUT_S)
    assert r.status_code == 200 and r.json()["counted"] is True
    r = submit(url, "d0000000-0000-0000-0000-000000000011")
    assert r.status_code == 201
    assert "replicated" not in r.json(), r.json()
    time.sleep(2.0)
    r = submit(url, "d0000000-0000-0000-0000-000000000012")
    assert r.status_code == 201
    assert r.json().get("replicated") is False
    assert "ghost" not in p1.api.replication_acks
    assert "ghost" not in p1.api.replication_ack_meta


# ------------------------------------------------------------------ long-poll


@PKGS
def test_journal_long_poll_returns_on_commit(P, rigs):
    """A parked long-poll returns as soon as a write commits."""
    rig = rigs(P, lease=False)
    p, url = rig.boot("n1")
    seq0 = p.store.last_seq()
    results = {}

    def poll():
        t0 = time.monotonic()
        r = requests.get(
            f"{url}/replication/journal?after_seq={seq0}&wait_s=10",
            headers=ADMIN, timeout=TIMEOUT_S)
        results["elapsed"] = time.monotonic() - t0
        results["events"] = r.json().get("events", [])

    t = threading.Thread(target=poll, daemon=True)
    t.start()
    time.sleep(0.5)  # let the poll park
    assert submit(url, "d0000000-0000-0000-0000-000000000004"
                  ).status_code == 201
    t.join(timeout=10)
    assert not t.is_alive()
    assert results["events"], "long-poll returned no events"
    assert results["elapsed"] < 5.0


@PKGS
def test_follower_stop_outlasts_a_parked_long_poll(P, rigs):
    """`stop()` joins the sync thread for longer than a long-poll can
    park (timeout_s + long_poll_s + 5), so a leader's late answer is
    never applied after it returns: stop() during a parked poll returns
    with the thread gone, and a commit after that reaches nothing."""
    rig = rigs(P, lease=False)
    p, url = rig.boot("n1")
    store = P.store.JobStore()
    follower = P.replication.JournalFollower(
        store, leader_url_fn=lambda: url, poll_s=0.05, timeout_s=3.0,
        long_poll_s=1.5, member_id="f")
    follower.start()
    wait(lambda: "f" in p.api.replication_ack_meta, TIMEOUT_S, "first ack")
    time.sleep(0.3)  # parked in its long-poll now
    follower.stop()
    assert not follower._thread.is_alive()
    applied = follower.synced_events
    assert submit(url, "d0000000-0000-0000-0000-000000000005"
                  ).status_code == 201
    time.sleep(0.5)
    assert follower.synced_events == applied
    assert "d0000000-0000-0000-0000-000000000005" not in store.jobs


def test_follower_join_covers_the_long_poll():
    """The join bound itself: the port's stop() waits
    timeout_s + long_poll_s + 5 for the sync thread, as the reference's
    (`cook_tpu/control/replication.py`) does."""
    joins = []

    class Thread:
        def join(self, timeout=None):
            joins.append(timeout)

    for P in (REF, PORT):
        follower = P.replication.JournalFollower(
            P.store.JobStore(), leader_url_fn=lambda: "", timeout_s=4.0,
            long_poll_s=2.0)
        follower._thread = Thread()
        follower.stop()
    assert joins == [11.0, 11.0]


# ------------------------------------------------------------ the standby role


@PKGS
def test_standby_wiring_and_promotion_order(P, rigs):
    """While standing by: not the leader, a passive scheduler, the
    leader's URL for proxying, a follower writing this node's journal,
    and replica reads stamped with staleness.  After promotion the
    follower's thread is gone, the scheduler active and reads
    unstamped."""
    rig = rigs(P)
    p1, url1 = rig.lead("n1")
    p2, url2, standby = rig.stand_by("n2", nudge=url1)
    wait(lambda: p2.member_id in p1.api.replication_ack_meta, TIMEOUT_S,
         "the standby's first ack")
    assert not p2.api.leader and not p2.scheduler.active
    assert p2.api.leader_url == url1
    assert p2.follower.journal is p2.journal
    assert p2.api.staleness_fn == p2.follower.staleness_view
    uuid = "d0000000-0000-0000-0000-000000000006"
    assert submit(url1, uuid).status_code == 201
    wait(lambda: uuid in p2.store.jobs, TIMEOUT_S, "replication")
    r = requests.get(f"{url2}/jobs/{uuid}", headers=H, timeout=TIMEOUT_S,
                     allow_redirects=False)
    assert r.status_code == 200 and "X-Cook-Staleness-Ms" in r.headers
    # /debug/* is served on a replica, stamped too
    debug = requests.get(f"{url2}/debug", timeout=TIMEOUT_S).json()
    assert debug["leader"] is False and debug["staleness_ms"] >= 0
    rig.kill(p1)
    standby.join(timeout=30)
    assert p2.is_leader()
    assert not p2.follower._thread.is_alive()
    assert p2.scheduler.active and p2.api.leader
    assert p2.api.leader_url == "" and p2.api.staleness_fn is None
    r = requests.get(f"{url2}/jobs/{uuid}", headers=H, timeout=TIMEOUT_S)
    assert r.status_code == 200 and "X-Cook-Staleness-Ms" not in r.headers


@PKGS
def test_deposed_leader_late_answer_is_not_applied_after_promotion(P, rigs):
    """The leader loses its lease but keeps serving (a partition from the
    lease service) while the standby's long-poll is parked on it: the
    standby promotes only after its follower's full join, and nothing the
    deposed leader commits afterwards reaches the promoted standby."""
    rig = rigs(P)
    p1, url1 = rig.lead("n1")
    p2, _, standby = rig.stand_by("n2", nudge=url1)
    wait(lambda: p2.member_id in p1.api.replication_ack_meta, TIMEOUT_S,
         "the standby's first ack")
    time.sleep(0.3)  # the follower parks its next long-poll on p1
    p1.selector.stop()  # the lease lapses; p1's REST keeps committing
    racing = threading.Thread(target=lambda: (
        time.sleep(0.5),
        submit(url1, "d0000000-0000-0000-0000-000000000007")), daemon=True)
    racing.start()
    standby.join(timeout=30)
    racing.join(timeout=TIMEOUT_S)
    assert p2.is_leader(), "standby never promoted"
    assert not p2.follower._thread.is_alive()
    seq = p2.store.last_seq()
    late = "d0000000-0000-0000-0000-000000000008"
    assert submit(url1, late).status_code == 201
    time.sleep(0.5)
    assert late not in p2.store.jobs and p2.store.last_seq() == seq
