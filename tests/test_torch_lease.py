"""The lease service and the HTTP elector (`cook_tpu_torch/control/
lease_server.py`, `control/leader.HttpLeaseElector`) and the replica-read
decision rule (`shard/replica.evaluate_staleness`) against the
reference's on the CPU: the cases of tests/test_leader_election.py's
lease half, tests/test_leader_http_failover.py's clamped-TTL case and
tests/test_replica_reads.py's decision table, each on both packages (`P`
over `ref` / `port`).

The clamped-TTL cases pin the reference fix the port copies: the server
clamps a requested TTL and answers with the effective one, which the
elector adopts for its partition grace."""
import json
import urllib.error
import urllib.request
from types import SimpleNamespace

import pytest

from cook_tpu.control import leader as ref_leader
from cook_tpu.control import lease_server as ref_lease
from cook_tpu.shard import replica as ref_replica
from cook_tpu_torch.control import leader as port_leader
from cook_tpu_torch.control import lease_server as port_lease
from cook_tpu_torch.shard import replica as port_replica

REF = SimpleNamespace(name="ref", leader=ref_leader, lease=ref_lease,
                      replica=ref_replica)
PORT = SimpleNamespace(name="port", leader=port_leader, lease=port_lease,
                       replica=port_replica)
PKGS = pytest.mark.parametrize("P", [REF, PORT], ids=["ref", "port"])


class FakeMonoClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _post(url, payload, timeout=2):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _status(req):
    try:
        with urllib.request.urlopen(req, timeout=2) as r:
            return r.status
    except urllib.error.HTTPError as e:
        return e.code


# ---------------------------------------------------------------- LeaseTable


@PKGS
def test_lease_table_grant_fence_expire(P):
    clock = FakeMonoClock()
    table = P.lease.LeaseTable(clock=clock)
    a = table.acquire("g", "A", "http://a", ttl_s=10)
    assert a["acquired"] and a["epoch"] == 1 and a["ttl_s"] == 10
    # B cannot take a live lease
    assert not table.acquire("g", "B", "http://b", ttl_s=10)["acquired"]
    # A renews with its epoch; a stale epoch is fenced off
    hb = table.heartbeat("g", "A", epoch=1, ttl_s=10)
    assert hb["ok"] and hb["ttl_s"] == 10
    assert not table.heartbeat("g", "A", epoch=0, ttl_s=10)["ok"]
    # expiry hands the lease to B, and A's next heartbeat is refused
    clock.t += 11
    b = table.acquire("g", "B", "http://b", ttl_s=10)
    assert b["acquired"] and b["epoch"] == 2
    hb = table.heartbeat("g", "A", epoch=1, ttl_s=10)
    assert not hb["ok"] and hb["leader"] == "B"
    assert table.current("g")["leader"] == "B"


@PKGS
def test_lease_table_release_and_reacquire_bumps_epoch(P):
    table = P.lease.LeaseTable(clock=FakeMonoClock())
    a = table.acquire("g", "A", "", ttl_s=10)
    assert table.release("g", "A", epoch=a["epoch"])["released"]
    assert table.current("g")["leader"] is None
    # a stale-epoch release is a no-op
    b = table.acquire("g", "B", "", ttl_s=10)
    assert not table.release("g", "B", epoch=b["epoch"] - 1)["released"]
    assert table.current("g")["leader"] == "B"


# ------------------------------------------------------------ HttpLeaseElector


@PKGS
def test_http_elector_single_leader_over_http(P):
    server = P.lease.LeaseServer().start()
    try:
        a = P.leader.HttpLeaseElector(server.url, "cook", "A", ttl_s=5,
                                      advertised_url="http://a:1")
        b = P.leader.HttpLeaseElector(server.url, "cook", "B", ttl_s=5,
                                      advertised_url="http://b:2")
        assert a.try_acquire()
        assert not b.try_acquire()
        assert b.current_leader() == "A"
        assert b.current_leader_url() == "http://a:1"
        assert a.heartbeat()
        a.release()
        assert b.try_acquire()
        assert a.current_leader() == "B"
        # A's heartbeat now carries a fenced-off epoch: definitive loss
        assert not a.heartbeat()
    finally:
        server.stop()


@PKGS
def test_http_elector_partition_grace_then_fail_fast(P):
    """Losing the lease SERVICE is indeterminate: the leader keeps leading
    for up to one TTL past its last confirmed renewal, then fails fast."""
    server = P.lease.LeaseServer().start()
    clock = FakeMonoClock()
    elector = P.leader.HttpLeaseElector(server.url, "cook", "A", ttl_s=5,
                                        timeout_s=0.5, clock=clock)
    assert elector.try_acquire()
    server.stop()  # partition: the service is gone
    clock.t += 3
    assert elector.heartbeat()  # within TTL of the last renewal
    clock.t += 3
    assert not elector.heartbeat()  # past TTL: fail fast


@PKGS
def test_lease_server_restart_fences_old_leader_within_one_ttl(P):
    """A restarted lease service holds no lease: the OLD leader's next
    heartbeat is a definitive loss, whoever re-acquires first."""
    server = P.lease.LeaseServer(port=0).start()
    port = server.port
    a = P.leader.HttpLeaseElector(server.url, "cook", "A", ttl_s=5,
                                  timeout_s=1.0, advertised_url="http://a:1")
    b = P.leader.HttpLeaseElector(server.url, "cook", "B", ttl_s=5,
                                  timeout_s=1.0, advertised_url="http://b:2")
    assert a.try_acquire()
    server.stop()
    server2 = P.lease.LeaseServer(port=port).start()
    try:
        # case 1: the standby wins the re-acquire race
        assert b.try_acquire()
        assert not a.heartbeat()
        # case 2: the sitting leader re-acquires first after a restart
        server2.table._leases.clear()
        assert a.try_acquire()
        assert not b.heartbeat()
    finally:
        server2.stop()


@PKGS
def test_lease_server_clamps_ttl_and_exact_paths(P):
    """A huge requested TTL must not lock the group to a dead member, the
    grant answers with the clamped TTL, and path matching is exact."""
    clock = FakeMonoClock()
    server = P.lease.LeaseServer(clock=clock).start()
    try:
        resp = _post(server.url + "/acquire",
                     {"group": "g", "member": "A", "ttl_s": 1e9})
        assert resp["acquired"] and resp["ttl_s"] == P.lease.MAX_TTL_S
        resp = _post(server.url + "/heartbeat",
                     {"group": "g", "member": "A", "epoch": resp["epoch"],
                      "ttl_s": 0.01})
        assert resp["ok"] and resp["ttl_s"] == 0.5  # the floor
        # server-side clamp: the lease lapses after MAX_TTL_S, not 1e9 s
        clock.t += P.lease.MAX_TTL_S + 1
        resp = _post(server.url + "/acquire",
                     {"group": "g", "member": "B", "ttl_s": 10})
        assert resp["acquired"], "huge client TTL locked the group"
        assert _status(urllib.request.Request(
            server.url + "/leaderfoo")) == 404
        assert _status(urllib.request.Request(
            server.url + "/acquire",
            data=json.dumps({"group": "g", "member": "C",
                             "ttl_s": "bogus"}).encode(),
            headers={"Content-Type": "application/json"},
            method="POST")) == 400
        assert _status(urllib.request.Request(server.url + "/healthz")) \
            == 200
    finally:
        server.stop()


@PKGS
def test_clamped_ttl_adopted_for_partition_grace(P):
    """The elector grace-checks a partition against the EFFECTIVE TTL the
    service reports back, not its configured ask."""
    lease = P.lease.LeaseServer().start()
    clock = {"t": 0.0}
    try:
        elector = P.leader.HttpLeaseElector(
            lease.url, "g", "m1", ttl_s=300.0, timeout_s=1.0,
            clock=lambda: clock["t"])
        assert elector.try_acquire()
        assert elector.effective_ttl_s == P.lease.MAX_TTL_S  # 60, not 300
        elector.endpoint = "http://127.0.0.1:1"  # partition
        clock["t"] = P.lease.MAX_TTL_S / 2
        assert elector.heartbeat(), \
            "partition within the granted TTL must not dethrone"
        clock["t"] = P.lease.MAX_TTL_S + 40.0
        assert not elector.heartbeat(), (
            "elector kept leading past the clamped TTL")
    finally:
        lease.stop()


# ------------------------------------------------- replica-read decisions


@PKGS
def test_evaluate_staleness_decision_table(P):
    evaluate = P.replica.evaluate_staleness
    fresh = {0: {"staleness_ms": 10.0, "stalled_s": 0.1},
             1: {"staleness_ms": 40.0, "stalled_s": 0.1}}
    verdict = evaluate(fresh, ceiling_ms=100.0, refuse_after_s=30.0)
    assert verdict == {"action": "serve", "staleness_ms": 40.0,
                       "shards": {0: 10.0, 1: 40.0}}
    over = {**fresh, 1: {"staleness_ms": 500.0, "stalled_s": 0.1}}
    assert evaluate(over, ceiling_ms=100.0,
                    refuse_after_s=30.0)["action"] == "fallback"
    stalled = {**fresh, 1: {"staleness_ms": 50.0, "stalled_s": 90.0}}
    assert evaluate(stalled, ceiling_ms=100.0,
                    refuse_after_s=30.0)["action"] == "refuse"
    # never-synced but actively polling: fall back to the leader
    catching_up = {0: {"staleness_ms": float("inf"), "stalled_s": 0.1}}
    assert evaluate(catching_up, ceiling_ms=1e12,
                    refuse_after_s=30.0)["action"] == "fallback"
    # never synced AND not polling either: refuse outright
    never = {0: {"staleness_ms": float("inf"),
                 "stalled_s": float("inf")}}
    assert evaluate(never, ceiling_ms=1e12,
                    refuse_after_s=1e12)["action"] == "refuse"
    # an empty view (no shard row yet) serves nothing stale: staleness 0
    assert evaluate({}, ceiling_ms=1.0, refuse_after_s=1.0) == {
        "action": "serve", "staleness_ms": 0.0, "shards": {}}

