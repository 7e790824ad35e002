"""The replication wire format and the REST layer's parked waits, on the
CPU: the replica-read cases of tests/test_replica_reads.py (serve,
refuse, fall back), unsharded and on its 2-shard rig (with the per-shard
staleness split), on both packages (`P` over `ref` / `port`), a follower
of one package tailing a leader of the other, and long-polls and a
sync-ack submit parked at once while a third request is served (the port
parks them with its loop lock released, `rest/api.py`), on one store and
on two shards."""
import http.client
import json
import threading
import time
import urllib.parse
from types import SimpleNamespace

import pytest
import requests
import torch

from cook_tpu import faults as ref_faults
from cook_tpu.control import replication as ref_replication
from cook_tpu.models import persistence as ref_persist
from cook_tpu.models import store as ref_store
from cook_tpu.rest import api as ref_api
from cook_tpu.rest import server as ref_server
from cook_tpu.shard import ShardedStore as RefShardedStore
from cook_tpu.shard import replica as ref_shard_replica
from cook_tpu_torch import faults as port_faults
from cook_tpu_torch.control import replication as port_replication
from cook_tpu_torch.models import persistence as port_persist
from cook_tpu_torch.models import store as port_store
from cook_tpu_torch.rest import api as port_api
from cook_tpu_torch.rest import server as port_server
from cook_tpu_torch.shard import ShardedStore as PortShardedStore
from cook_tpu_torch.shard import replica as port_shard_replica
from cook_tpu_torch.shard import router as port_shard_router

torch.set_num_threads(1)

REF = SimpleNamespace(name="ref", faults=ref_faults,
                      replication=ref_replication, persist=ref_persist,
                      store=ref_store, api=ref_api, server=ref_server,
                      ShardedStore=RefShardedStore,
                      shard_replica=ref_shard_replica)
PORT = SimpleNamespace(name="port", faults=port_faults,
                       replication=port_replication, persist=port_persist,
                       store=port_store, api=port_api, server=port_server,
                       ShardedStore=PortShardedStore,
                       shard_replica=port_shard_replica)
PKGS = pytest.mark.parametrize("P", [REF, PORT], ids=["ref", "port"])
ADMIN = {"X-Cook-Requesting-User": "admin"}
TIMEOUT_S = 15


def raw_get(url: str, path: str):
    """(status, headers, body) WITHOUT following redirects."""
    parsed = urllib.parse.urlparse(url)
    conn = http.client.HTTPConnection(parsed.hostname, parsed.port,
                                      timeout=TIMEOUT_S)
    try:
        conn.request("GET", path, headers=ADMIN)
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def submit(url, jobs, timeout=TIMEOUT_S):
    r = requests.post(f"{url}/jobs", json={"jobs": jobs}, headers=ADMIN,
                      timeout=timeout)
    assert r.status_code == 201, r.text
    return r.json()


def job(uuid, pool=None):
    spec = {"uuid": uuid, "command": "true", "mem": 64, "cpus": 0.5}
    if pool is not None:
        spec["pool"] = pool
    return spec


def wait_until(pred, timeout_s=TIMEOUT_S, what="condition"):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout_s:
        if pred():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


# ------------------------------------------------------ replica reads


@pytest.fixture
def rig(request):
    """An unsharded leader (store, journal, API) and a replica: a
    follower tailing it into a second store behind a non-leader API."""
    P = request.param
    leader = P.server.InprocessControlPlane().start()
    store2 = P.store.JobStore()
    follower = P.replication.JournalFollower(
        store2, leader_url_fn=lambda: leader.url,
        self_url="http://replica", member_id="replica",
        poll_s=0.05, timeout_s=2.0, long_poll_s=0.1).start()
    api2 = P.api.CookApi(store2, None, P.api.ApiConfig())
    api2.leader = False
    api2.leader_url = leader.url
    api2.staleness_fn = follower.staleness_view
    replica = P.server.ServerThread(api2).start()
    try:
        yield SimpleNamespace(P=P, leader=leader, replica=replica, api2=api2,
                              follower=follower, store2=store2)
    finally:
        P.faults.disarm()
        follower.stop()
        replica.stop()
        leader.stop()


RIGS = pytest.mark.parametrize("rig", [REF, PORT], ids=["ref", "port"],
                               indirect=True)


@RIGS
def test_replica_serves_with_staleness_headers_and_field(rig):
    submit(rig.leader.url, [job("r-0")])
    wait_until(lambda: "r-0" in rig.store2.jobs, what="replica sync")
    status, headers, body = raw_get(rig.replica.url, "/jobs/r-0")
    assert status == 200
    staleness = headers["X-Cook-Staleness-Ms"]
    assert staleness != "inf" and int(staleness) < 60_000
    # an unsharded follower is shard 0 of a one-shard view
    assert set(json.loads(headers["X-Cook-Shard-Staleness"])) == {"0"}
    payload = json.loads(body)
    assert payload["uuid"] == "r-0" and "staleness_ms" in payload
    # /debug/* is stamped too (served, never redirected)
    status, headers, _ = raw_get(rig.replica.url, "/debug/contention")
    assert status == 200 and "X-Cook-Staleness-Ms" in headers
    status, _, body = raw_get(rig.replica.url, "/debug/replica")
    view = json.loads(body)
    assert view["leader"] is False and view["decision"]["action"] == \
        "serve"
    assert view["shards"]["0"]["applied_seq"] == rig.store2.last_seq()
    # the leader never stamps staleness: its reads are authoritative
    status, headers, _ = raw_get(rig.leader.url, "/jobs/r-0")
    assert status == 200 and "X-Cook-Staleness-Ms" not in headers


@RIGS
def test_replica_that_stops_applying_refuses_reads(rig):
    faults = rig.P.faults
    submit(rig.leader.url, [job("s-0")])
    wait_until(lambda: "s-0" in rig.store2.jobs, what="replica sync")
    faults.arm(faults.FaultSchedule([faults.FaultRule(
        point=faults.REPLICATION_FETCH, mode="error")]))
    rig.api2.config.replica_refuse_after_s = 0.05
    time.sleep(0.3)  # several failed polls: stalled_s passes the bound
    status, _, body = raw_get(rig.replica.url, "/jobs/s-0")
    assert status == 503
    assert b"stopped applying" in body
    status, _, body = raw_get(rig.replica.url, "/debug/replica")
    assert json.loads(body)["decision"]["action"] == "refuse"


@RIGS
def test_staleness_over_ceiling_falls_back_to_leader(rig):
    submit(rig.leader.url, [job("f-0")])
    wait_until(lambda: "f-0" in rig.store2.jobs, what="replica sync")
    # ceiling below any possible staleness: every gated read redirects
    rig.api2.config.replica_staleness_ceiling_ms = -1.0
    status, headers, _ = raw_get(rig.replica.url, "/jobs/f-0")
    assert status == 307
    assert headers["Location"] == f"{rig.leader.url}/jobs/f-0"
    # back under the ceiling: served locally again
    rig.api2.config.replica_staleness_ceiling_ms = 60_000.0
    status, headers, _ = raw_get(rig.replica.url, "/jobs/f-0")
    assert status == 200 and "X-Cook-Staleness-Ms" in headers


# ------------------------------------------- replica reads, two shards


N_SHARDS = 2


@pytest.fixture
def srig(request):
    """tests/test_replica_reads.py's rig: a 2-shard leader (store, one
    journal segment per shard, the sharded pipeline, API) and a replica
    whose sharded follower tails each shard's feed into a second sharded
    store behind a non-leader API."""
    P = request.param
    leader = P.server.InprocessControlPlane(
        shards=N_SHARDS, pools=("pool0", "pool1")).start()
    store2 = P.ShardedStore(N_SHARDS)
    follower = P.shard_replica.ShardedJournalFollower(
        store2, leader_url_fn=lambda: leader.url,
        self_url="http://replica", member_id="replica",
        poll_s=0.05, timeout_s=2.0, long_poll_s=0.1).start()
    api2 = P.api.CookApi(store2, None, P.api.ApiConfig())
    api2.leader = False
    api2.leader_url = leader.url
    api2.staleness_fn = follower.staleness_view
    replica = P.server.ServerThread(api2).start()
    try:
        yield SimpleNamespace(P=P, leader=leader, replica=replica, api2=api2,
                              follower=follower, store2=store2)
    finally:
        P.faults.disarm()
        follower.stop()
        replica.stop()
        leader.stop()


SRIGS = pytest.mark.parametrize("srig", [REF, PORT], ids=["ref", "port"],
                                indirect=True)


def shard_staleness(headers) -> dict:
    return json.loads(headers["X-Cook-Shard-Staleness"])


def every_shard_proved_fresh(srig) -> bool:
    """Each shard follower has had a fetch answered: `pool0` and `pool1`
    lie on one shard, and the other's first freshness proof can come
    after its jobs have synced on a loaded host."""
    return all(row["staleness_ms"] != float("inf")
               for row in srig.follower.staleness_view().values())


@SRIGS
def test_sharded_replica_serves_with_staleness_headers_and_field(srig):
    submit(srig.leader.url, [job("r-0", "pool0")])
    submit(srig.leader.url, [job("r-1", "pool1")])
    wait_until(lambda: "r-0" in srig.store2.jobs
               and "r-1" in srig.store2.jobs
               and every_shard_proved_fresh(srig), what="replica sync")
    status, headers, body = raw_get(srig.replica.url, "/jobs/r-1")
    assert status == 200
    staleness = headers["X-Cook-Staleness-Ms"]
    assert staleness != "inf" and int(staleness) < 60_000
    assert set(shard_staleness(headers)) == {"0", "1"}
    payload = json.loads(body)
    assert payload["uuid"] == "r-1"
    assert "staleness_ms" in payload
    # /debug/* is stamped too (served, never redirected)
    status, headers, _ = raw_get(srig.replica.url, "/debug/contention")
    assert status == 200 and "X-Cook-Staleness-Ms" in headers
    status, _, body = raw_get(srig.replica.url, "/debug/replica")
    view = json.loads(body)
    assert set(view["shards"]) == {"0", "1"}
    for i, shard in enumerate(srig.store2.shards):
        assert view["shards"][str(i)]["applied_seq"] == shard.last_seq()
    # the leader never stamps staleness: its reads are authoritative
    status, headers, _ = raw_get(srig.leader.url, "/jobs/r-1")
    assert status == 200 and "X-Cook-Staleness-Ms" not in headers


@SRIGS
def test_staleness_is_monotone_per_shard_while_behind(srig):
    faults = srig.P.faults
    submit(srig.leader.url, [job("m-0", "pool0")])
    wait_until(lambda: "m-0" in srig.store2.jobs, what="replica sync")
    # cut replication: the replica's freshness proof stops refreshing
    faults.arm(faults.FaultSchedule([faults.FaultRule(
        point=faults.REPLICATION_FETCH, mode="error")]))
    submit(srig.leader.url, [job("m-1", "pool0")])
    time.sleep(0.2)
    _, headers_a, _ = raw_get(srig.replica.url, "/jobs/m-0")
    time.sleep(0.3)
    _, headers_b, _ = raw_get(srig.replica.url, "/jobs/m-0")
    a, b = shard_staleness(headers_a), shard_staleness(headers_b)
    for shard in a:
        assert b[shard] >= a[shard], (a, b)
    assert int(headers_b["X-Cook-Staleness-Ms"]) > \
        int(headers_a["X-Cook-Staleness-Ms"])


@SRIGS
def test_sharded_replica_that_stops_applying_refuses_reads(srig):
    faults = srig.P.faults
    submit(srig.leader.url, [job("s-0", "pool0")])
    wait_until(lambda: "s-0" in srig.store2.jobs, what="replica sync")
    faults.arm(faults.FaultSchedule([faults.FaultRule(
        point=faults.REPLICATION_FETCH, mode="error")]))
    srig.api2.config.replica_refuse_after_s = 0.05
    time.sleep(0.3)  # several failed polls: stalled_s passes the bound
    status, _, body = raw_get(srig.replica.url, "/jobs/s-0")
    assert status == 503
    assert b"stopped applying" in body
    status, _, body = raw_get(srig.replica.url, "/debug/replica")
    assert json.loads(body)["decision"]["action"] == "refuse"


@SRIGS
def test_sharded_staleness_over_ceiling_falls_back_to_leader(srig):
    submit(srig.leader.url, [job("f-0", "pool1")])
    wait_until(lambda: "f-0" in srig.store2.jobs
               and every_shard_proved_fresh(srig), what="replica sync")
    # ceiling below any possible staleness: every gated read redirects
    srig.api2.config.replica_staleness_ceiling_ms = -1.0
    status, headers, _ = raw_get(srig.replica.url, "/jobs/f-0")
    assert status == 307
    assert headers["Location"].startswith(srig.leader.url)
    assert headers["Location"].endswith("/jobs/f-0")
    # back under the ceiling: served locally again
    srig.api2.config.replica_staleness_ceiling_ms = 60_000.0
    status, headers, _ = raw_get(srig.replica.url, "/jobs/f-0")
    assert status == 200 and "X-Cook-Staleness-Ms" in headers


@PKGS
def test_idle_leader_staleness_climbs_through_the_long_poll(P):
    """A caught-up follower proves freshness only when a fetch returns,
    and on an idle leader each fetch parks its whole long-poll: its
    staleness climbs to about long_poll_s + poll_s with nothing behind,
    so reads pass a ceiling below that (ROADMAP Queue C reference item
    11; the port copies the behaviour)."""
    leader = P.server.InprocessControlPlane().start()
    store2 = P.store.JobStore()
    follower = P.replication.JournalFollower(
        store2, leader_url_fn=lambda: leader.url, self_url="http://replica",
        member_id="replica", poll_s=0.2, timeout_s=2.0,
        long_poll_s=1.0).start()
    try:
        submit(leader.url, [job("i-0")])
        wait_until(lambda: "i-0" in store2.jobs
                   and follower.staleness_ms() < 500, what="replica sync")
        samples = []
        t0 = time.monotonic()
        while time.monotonic() - t0 < 2.5:
            samples.append(follower.staleness_ms())
            time.sleep(0.02)
        assert store2.last_seq() == leader.store.last_seq()
        assert 900 <= max(samples) <= 2000, max(samples)
    finally:
        follower.stop()
        leader.stop()


# ------------------------------------------------- the loop lock, released


@PKGS
def test_parked_long_poll_and_sync_ack_leave_the_api_serving(P):
    """A sync-ack submit waiting for its ack and a journal long-poll
    parked at the head, at the same time: a third request is answered
    meanwhile, the ack that arrives ends the submit's wait, and the next
    commit ends the long-poll.  On a port that held its loop lock while
    waiting, the third request would wait out the ack timeout."""
    cp = P.server.InprocessControlPlane(config=P.api.ApiConfig(
        replication_sync_ack=True, replication_ack_timeout_s=8.0)).start()
    out = {}
    try:
        def submit_a():
            out["a"] = requests.post(f"{cp.url}/jobs", json={"jobs": [
                job("c-a")]}, headers=ADMIN, timeout=TIMEOUT_S)

        s = threading.Thread(target=submit_a, daemon=True)
        s.start()
        # the transaction's last event is its txn/committed record: from
        # there on the submit waits for its ack
        wait_until(lambda: any(t["op"] == "jobs/submit"
                               for t in list(cp.store.txn_results.values())),
                   what="the commit")
        head = cp.store.last_seq()

        def long_poll():
            out["poll"] = requests.get(
                f"{cp.url}/replication/journal?after_seq={head}&wait_s=8",
                headers=ADMIN, timeout=TIMEOUT_S).json()

        poll = threading.Thread(target=long_poll, daemon=True)
        poll.start()
        time.sleep(0.3)
        assert s.is_alive() and poll.is_alive()
        t0 = time.monotonic()
        r = requests.get(f"{cp.url}/debug", timeout=TIMEOUT_S)
        assert r.status_code == 200 and time.monotonic() - t0 < 2.0
        assert s.is_alive() and poll.is_alive(), "a parked wait returned"
        r = requests.post(f"{cp.url}/replication/ack", json={
            "follower": "f", "seq": head, "durable": True},
            headers=ADMIN, timeout=TIMEOUT_S)
        assert r.json() == {"ok": True, "counted": True}
        s.join(timeout=TIMEOUT_S)
        assert not s.is_alive() and out["a"].status_code == 201
        assert "replicated" not in out["a"].json()
        assert poll.is_alive()
        # covered by an ack ahead of it: this commit waits for nothing
        requests.post(f"{cp.url}/replication/ack", json={
            "follower": "f", "seq": 10**6, "durable": True},
            headers=ADMIN, timeout=TIMEOUT_S)
        assert "replicated" not in submit(cp.url, [job("c-b")])
        poll.join(timeout=TIMEOUT_S)
        assert not poll.is_alive()
        assert any(e["kind"] == "job/created"
                   for e in out["poll"]["events"])
    finally:
        cp.stop()


@PKGS
def test_parked_shard_long_polls_and_cross_shard_sync_ack(P):
    """On a 2-shard leader: a long-poll parked at each shard's head and a
    cross-shard sync-ack submit waiting for both shards' acks, all at
    once, while a third request is answered.  The submit's 201 waits
    until each shard it touched is acked at that shard's own seq (an ack
    on one shard does not end it), and every shard's next commit ends
    that shard's long-poll."""
    pools = port_shard_router.ShardRouter(2).pools_for_distinct_shards()
    cp = P.server.InprocessControlPlane(
        shards=2, pools=tuple(pools), config=P.api.ApiConfig(
            replication_sync_ack=True, replication_ack_timeout_s=8.0)
    ).start()
    router = cp.store.router
    assert [router.shard_for_pool(p) for p in pools] == [0, 1]
    out = {}
    try:
        def submit_x():
            out["x"] = requests.post(f"{cp.url}/jobs", json={"jobs": [
                job("x-0", pools[0]), job("x-1", pools[1])]}, headers=ADMIN,
                timeout=TIMEOUT_S)

        s = threading.Thread(target=submit_x, daemon=True)
        s.start()
        wait_until(lambda: all(
            any(t["op"] == "jobs/submit"
                for t in list(shard.txn_results.values()))
            for shard in cp.store.shards), what="the cross-shard commit")
        heads = cp.store.last_seqs()

        def long_poll(i):
            out[f"poll{i}"] = requests.get(
                f"{cp.url}/replication/journal?after_seq={heads[i]}"
                f"&wait_s=8&shard={i}", headers=ADMIN,
                timeout=TIMEOUT_S).json()

        polls = [threading.Thread(target=long_poll, args=(i,), daemon=True)
                 for i in range(2)]
        for t in polls:
            t.start()
        time.sleep(0.3)
        t0 = time.monotonic()
        r = requests.get(f"{cp.url}/debug", timeout=TIMEOUT_S)
        assert r.status_code == 200 and time.monotonic() - t0 < 2.0
        assert s.is_alive() and all(t.is_alive() for t in polls)
        # shard 0 acked: the submit still waits for shard 1
        r = requests.post(f"{cp.url}/replication/ack", json={
            "follower": "f", "seq": heads[0], "durable": True, "shard": 0},
            headers=ADMIN, timeout=TIMEOUT_S)
        assert r.json() == {"ok": True, "counted": True}
        time.sleep(0.3)
        assert s.is_alive(), "the submit returned with one shard acked"
        requests.post(f"{cp.url}/replication/ack", json={
            "follower": "f", "seq": heads[1], "durable": True, "shard": 1},
            headers=ADMIN, timeout=TIMEOUT_S)
        s.join(timeout=TIMEOUT_S)
        assert not s.is_alive() and out["x"].status_code == 201
        assert "replicated" not in out["x"].json()
        assert all(t.is_alive() for t in polls)
        for i in range(2):
            requests.post(f"{cp.url}/replication/ack", json={
                "follower": "f", "seq": 10**6, "durable": True, "shard": i},
                headers=ADMIN, timeout=TIMEOUT_S)
        assert "replicated" not in submit(cp.url, [job("y-0", pools[0]),
                                                   job("y-1", pools[1])])
        for i, t in enumerate(polls):
            t.join(timeout=TIMEOUT_S)
            assert not t.is_alive()
            assert any(e["kind"] == "job/created"
                       for e in out[f"poll{i}"]["events"])
    finally:
        cp.stop()


def test_server_stop_answers_parked_waits():
    """Stopping the port's server answers a parked long-poll at once (its
    handler threads are joined on close)."""
    cp = port_server.InprocessControlPlane().start()
    out = {}
    head = cp.store.last_seq()

    def long_poll():
        t0 = time.monotonic()
        out["poll"] = requests.get(
            f"{cp.url}/replication/journal?after_seq={head}&wait_s=20",
            headers=ADMIN, timeout=30).json()
        out["wall"] = time.monotonic() - t0

    poll = threading.Thread(target=long_poll, daemon=True)
    poll.start()
    time.sleep(0.3)
    t0 = time.monotonic()
    cp.stop()
    assert time.monotonic() - t0 < 5.0
    poll.join(timeout=TIMEOUT_S)
    assert out["poll"]["events"] == [] and out["wall"] < 5.0


# --------------------------------------------------- across the packages


def _normal(state: dict) -> dict:
    return json.loads(json.dumps(state, sort_keys=True))


@pytest.mark.parametrize("L,F", [(REF, PORT), (PORT, REF)],
                         ids=["port-follows-ref", "ref-follows-port"])
def test_follower_tails_the_other_packages_leader(L, F, tmp_path):
    """A follower of one package tails a leader of the other: 200
    journaled jobs applied from the feed, one snapshot bootstrap after the
    leader's incarnation changes, and at each point the two stores'
    `snapshot_state` equal; the follower's own disk recovers it."""
    (tmp_path / "leader").mkdir()
    leader = L.server.InprocessControlPlane(
        data_dir=str(tmp_path / "leader")).start()
    fdir = tmp_path / "follower"
    fdir.mkdir()
    store = F.store.JobStore()
    journal = F.persist.attach_journal(store, str(fdir / "journal.jsonl"))
    follower = F.replication.JournalFollower(
        store, leader_url_fn=lambda: leader.url, data_dir=str(fdir),
        journal=journal, long_poll_s=0.2, member_id="x")
    try:
        for b in range(4):
            submit(leader.url, [job(f"x-{b}-{i}") for i in range(50)])
        while follower.sync_once():
            pass
        assert len(store.jobs) == 200 and follower.full_resyncs == 0
        assert follower.synced_events > 200
        assert leader.api.replication_acks["x"] == leader.store.last_seq()
        assert _normal(F.persist.snapshot_state(store)) == \
            _normal(L.persist.snapshot_state(leader.store))
        # a leader restarted on its own disk stamps a fresh incarnation:
        # the follower cannot compare sequence numbers across it
        leader.api.incarnation = "restarted"
        submit(leader.url, [job(f"y-{i}") for i in range(10)])
        follower.sync_once()
        assert follower.full_resyncs == 1 and len(store.jobs) == 210
        assert _normal(F.persist.snapshot_state(store)) == \
            _normal(L.persist.snapshot_state(leader.store))
        journal.close()
        recovered = F.persist.recover(str(fdir))
        assert set(recovered.jobs) == set(leader.store.jobs)
    finally:
        journal.close()
        leader.stop()
