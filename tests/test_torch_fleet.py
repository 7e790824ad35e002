"""The fleet observatory of `cook_tpu_torch` (`obs/fleet.py`) against
`cook_tpu` on the CPU.

- The 11 cases of tests/test_fleet.py (peer polling, the peer-unreachable
  / peer-degraded reasons, federated incident capture with flap
  suppression, sticky peers, the headline parse, and the leader +
  follower drill over HTTP), each on both packages (`P` over `ref` /
  `port`) with the reference's assertions.
- The fleet-peer half of
  tests/test_replication_durability.py::test_standby_self_registers_as_fleet_peer
  on the port: a standby that acks the leader's journal feed with its URL
  is polled with no `peers` config.
- Across the packages: each package's observatory polls a control plane
  of the other to the same row keys, and both parse one exposition alike.
"""
import json
import threading
import time
from types import SimpleNamespace

import pytest
import requests
import torch

from cook_tpu import faults as ref_faults
from cook_tpu.obs import contention as ref_contention
from cook_tpu.obs import fleet as ref_fleet
from cook_tpu.obs import incident as ref_incident
from cook_tpu.obs import tsdb as ref_tsdb
from cook_tpu.rest import api as ref_api
from cook_tpu.rest import server as ref_server
from cook_tpu_torch import faults as port_faults
from cook_tpu_torch.obs import contention as port_contention
from cook_tpu_torch.obs import fleet as port_fleet
from cook_tpu_torch.obs import incident as port_incident
from cook_tpu_torch.obs import tsdb as port_tsdb
from cook_tpu_torch.rest import api as port_api
from cook_tpu_torch.rest import server as port_server

torch.set_num_threads(1)

REF = SimpleNamespace(name="ref", fleet=ref_fleet, incident=ref_incident,
                      faults=ref_faults, contention=ref_contention,
                      tsdb=ref_tsdb, api=ref_api, server=ref_server)
PORT = SimpleNamespace(name="port", fleet=port_fleet, incident=port_incident,
                       faults=port_faults, contention=port_contention,
                       tsdb=port_tsdb, api=port_api, server=port_server)
PKGS = pytest.mark.parametrize("P", [REF, PORT], ids=["ref", "port"])
PAIRS = pytest.mark.parametrize(
    "W,R", [(REF, PORT), (PORT, REF)], ids=["ref-polls-port",
                                            "port-polls-ref"])
ADMIN = {"X-Cook-Requesting-User": "admin"}


class FakePeers:
    """Injectable transport: a dict of url -> {path: body | Exception}."""

    def __init__(self, peers: dict):
        self.peers = peers

    def fetch(self, url: str, timeout_s: float):
        for base, routes in self.peers.items():
            if url.startswith(base):
                path = url[len(base):]
                body = routes.get(path, Exception(f"404 {path}"))
                if isinstance(body, Exception):
                    raise body
                return body
        raise OSError(f"connection refused: {url}")


def healthy_routes(reasons=()):
    return {
        "/debug/health": {
            "healthy": not reasons,
            "status": "ok" if not reasons else "degraded",
            "reasons": list(reasons),
            "checks": {"contention": {"commit_ack": {"p99_ms": 1.0},
                                      "journal": {},
                                      "endpoints": {}}},
        },
        "/debug/replica": {"shards": {"0": {"staleness_ms": 40.0}}},
        "/metrics": "cook_obs_health_degraded 0.0\n"
                    "cook_rest_in_flight 2.0\n",
        "/debug/incidents": {"incidents": [{"id": "inc-000007"}]},
    }


def make_fleet(P, peers: dict, **kw):
    fake = FakePeers(peers)
    kw.setdefault("incidents", P.incident.IncidentRecorder())
    fleet = P.fleet.FleetObservatory(self_url="http://leader",
                                     peers=tuple(peers),
                                     fetch_fn=fake.fetch, **kw)
    return fleet, fake


# --------------------------------------------------------------- polling


@PKGS
def test_healthy_peer_row_carries_staleness_and_headline(P):
    fleet, _ = make_fleet(P, {"http://peer-a": healthy_routes()})
    rows = fleet.poll_once()
    row = rows["http://peer-a"]
    assert row["ok"] and row["healthy"] and row["status"] == "ok"
    assert row["staleness"] == {"0": 40.0}
    assert row["headline"]["rest.in_flight"] == 2.0
    assert "commit_ack" in row["contention"]
    verdict = fleet.verdict()
    assert verdict["healthy"] and verdict["reasons"] == []
    assert verdict["worst_shard"] == {"node": "http://peer-a",
                                      "shard": "0", "staleness_ms": 40.0}


@PKGS
def test_dead_peer_becomes_unreachable_within_one_poll(P):
    fleet, _ = make_fleet(P, {"http://gone": {}})  # every fetch raises
    fleet.poll_once()
    verdict = fleet.verdict()
    assert verdict["status"] == "degraded"
    assert verdict["reasons"] == [P.fleet.PEER_UNREACHABLE]
    [row] = [n for n in verdict["nodes"] if not n.get("self")]
    assert not row["ok"] and "error" in row
    assert row["poll_age_s"] >= 0.0


@PKGS
def test_degraded_peer_attaches_its_own_reasons(P):
    fleet, fake = make_fleet(
        P, {"http://peer-a": healthy_routes(["fsync-stall"])})
    fleet.poll_once()
    verdict = fleet.verdict()
    assert verdict["reasons"] == [P.fleet.PEER_DEGRADED]
    [row] = [n for n in verdict["nodes"] if not n.get("self")]
    assert row["reasons"] == ["fsync-stall"]


@PKGS
def test_recovery_clears_the_reason_and_stamps_the_bundle(P):
    fake_routes = healthy_routes(["fsync-stall"])
    fleet, fake = make_fleet(P, {"http://peer-a": fake_routes})
    fleet.poll_once()
    bundle = fleet._peer_state["http://peer-a"]["bundle"]
    assert bundle is not None and bundle["recovered_time"] is None
    fake.peers["http://peer-a"] = healthy_routes()
    fleet.poll_once()
    assert fleet.verdict()["healthy"]
    assert bundle["recovered_time"] is not None


@PKGS
def test_federated_incident_references_the_peer_bundle(P):
    incidents = P.incident.IncidentRecorder()
    fleet, _ = make_fleet(
        P, {"http://peer-a": healthy_routes(["quality-drift"])},
        incidents=incidents)
    fleet.poll_once()
    [summary] = incidents.bundles()
    assert summary["trigger"] == "fleet-peer"
    bundle = incidents.get(summary["id"])
    [degradation] = bundle["verdict"]["degradations"]
    assert degradation["reason"] == P.fleet.PEER_DEGRADED
    assert degradation["peer"] == "http://peer-a"
    assert degradation["peer_reasons"] == ["quality-drift"]
    assert degradation["peer_incident_id"] == "inc-000007"
    json.dumps(bundle, default=str)  # bundle persists; must round-trip


@PKGS
def test_flapping_peer_is_cooldown_suppressed_then_deferred(P):
    incidents = P.incident.IncidentRecorder()
    routes = healthy_routes(["fsync-stall"])
    fleet, fake = make_fleet(P, {"http://peer-a": routes},
                             incidents=incidents, cooldown_s=3600.0)
    fleet.poll_once()                       # edge 1: captures
    assert len(incidents.bundles()) == 1
    for _ in range(3):                      # flap inside the cooldown
        fake.peers["http://peer-a"] = healthy_routes()
        fleet.poll_once()
        fake.peers["http://peer-a"] = routes
        fleet.poll_once()
    assert len(incidents.bundles()) == 1    # suppressed, not flooded
    state = fleet._peer_state["http://peer-a"]
    assert state["pending"]                 # ... but deferred, not lost
    state["last_capture"] = float("-inf")   # cooldown clears
    fleet.poll_once()
    assert len(incidents.bundles()) == 2


@PKGS
def test_unreachable_peer_capture_skips_the_bundle_reference(P):
    incidents = P.incident.IncidentRecorder()
    fleet, _ = make_fleet(P, {"http://gone": {}}, incidents=incidents)
    fleet.poll_once()
    [summary] = incidents.bundles()
    bundle = incidents.get(summary["id"])
    [degradation] = bundle["verdict"]["degradations"]
    assert degradation["reason"] == P.fleet.PEER_UNREACHABLE
    assert degradation["peer_incident_id"] is None


@PKGS
def test_peers_fn_registry_merges_and_excludes_self(P):
    fleet, _ = make_fleet(
        P, {"http://peer-a": healthy_routes()},
        peers_fn=lambda: ["http://leader", "http://peer-a/",
                          "http://peer-b"])
    assert fleet.peer_list() == ["http://peer-a", "http://peer-b"]


@PKGS
def test_crashed_peer_stays_unreachable_after_registry_prunes_it(P):
    """Peers are sticky: the dynamic registry half is the replication
    ack table, which liveness-prunes a crashed standby within seconds —
    the dead node must KEEP its peer-unreachable row, not vanish and
    flip the fleet verdict back to ok."""
    registry = {"urls": ["http://standby"]}
    fleet, fake = make_fleet(P, {"http://standby": healthy_routes()},
                             peers_fn=lambda: registry["urls"])
    fleet.peers = ()  # registry-only registration, the no-config path
    fleet.poll_once()
    assert fleet.verdict()["healthy"]
    # the standby crashes AND its acks age out of the registry
    fake.peers.pop("http://standby")
    registry["urls"] = []
    fleet.poll_once()
    verdict = fleet.verdict()
    assert verdict["reasons"] == [P.fleet.PEER_UNREACHABLE]
    assert "http://standby" in [n["url"] for n in verdict["nodes"]]
    # explicit decommission is the way a peer actually leaves
    fleet.forget_peer("http://standby")
    fleet.poll_once()
    assert fleet.verdict()["healthy"]
    assert fleet.peer_list() == []


EXPOSITION = ("# HELP cook_rank_queue_len x\n"
              "cook_rank_queue_len{pool=\"a\"} 3.0\n"
              "cook_rank_queue_len{pool=\"b\"} 9.0\n"
              "cook_obs_health_degraded 1.0\n"
              "cook_job_latency_end_to_end_bucket{le=\"1\"} 4\n"
              "garbage line\n")
HEADLINE = ("rank.queue_len", "obs.health.degraded", "job.latency.end_to_end")


@PKGS
def test_parse_headline_takes_worst_label_and_skips_histograms(P):
    out = P.fleet.parse_headline(EXPOSITION, HEADLINE)
    assert out == {"rank.queue_len": 9.0, "obs.health.degraded": 1.0}


# --------------------------------------------------------- live-style drill


@PKGS
def test_drill_leader_follower_fault_fleet_incident_history(P, tmp_path):
    """The acceptance drill: boot a leader + one follower control
    plane, arm a fault on the follower -> the leader's /debug/fleet
    shows the peer degraded (its own reasons attached) within one poll
    interval, the leader's incident ring gains a federated entry
    referencing the peer's bundle, the bundle embeds a non-empty
    pre-incident history slice; restart the leader and /debug/history
    still serves the pre-restart samples."""
    faults = P.faults
    follower_dir = tmp_path / "follower"
    follower_dir.mkdir()
    follower = P.server.InprocessControlPlane(
        config=P.api.ApiConfig(
            contention=P.contention.ContentionParams(fsync_stall_s=0.05)),
        history_sample_s=0,
        data_dir=str(follower_dir)).start()
    leader_history_dir = str(tmp_path / "leader-metrics")
    leader = P.server.InprocessControlPlane(history_sample_s=0).start()
    leader.api.history = P.tsdb.MetricsHistory(
        dir=leader_history_dir, config=P.tsdb.HistoryConfig(sample_s=0))
    leader.api.incidents.add_collector(
        "history", leader.api.history.incident_slice)
    fleet = P.fleet.FleetObservatory(
        self_url=leader.url, peers=(follower.url,), poll_s=0.2,
        incidents=leader.api.incidents,
        self_verdict_fn=leader.api.health_verdict)
    leader.api.fleet = fleet
    try:
        # pre-incident history on the leader: the health rollup gauge is
        # a key series, so sampling now gives the bundle its slice
        leader.api.health_verdict()
        leader.api.history.sample_once()
        time.sleep(0.05)
        leader.api.history.sample_once()

        # baseline: the follower is a healthy peer
        fleet.poll_once()
        assert leader.api.fleet.verdict()["healthy"]

        # arm the fault ON THE FOLLOWER's write path and trip it: a
        # 100 ms fsync stall against a 50 ms bound degrades its health
        faults.arm(faults.FaultSchedule([faults.FaultRule(
            point=faults.JOURNAL_FSYNC, mode="delay", delay_s=0.1)]))
        try:
            r = requests.post(
                f"{follower.url}/jobs",
                json={"jobs": [{"command": "true", "mem": 64,
                                "cpus": 0.5}]},
                headers=ADMIN, timeout=30)
            assert r.status_code == 201
        finally:
            faults.disarm()

        # within ONE poll interval the leader sees the degradation
        fleet.start()
        deadline = time.monotonic() + 5.0
        verdict = None
        while time.monotonic() < deadline:
            verdict = leader.api.fleet.verdict()
            if P.fleet.PEER_DEGRADED in verdict["reasons"]:
                break
            time.sleep(0.05)
        fleet.stop()
        assert verdict is not None \
            and P.fleet.PEER_DEGRADED in verdict["reasons"], verdict
        [row] = [n for n in verdict["nodes"] if not n.get("self")]
        assert "fsync-stall" in row["reasons"]
        assert row["poll_age_s"] < 5.0

        # the leader's incident ring gained a federated entry that
        # references the PEER's own bundle (the follower captured one
        # when its health was polled)
        federated = [b for b in leader.api.incidents.bundles()
                     if b["trigger"] == "fleet-peer"]
        assert federated, leader.api.incidents.bundles()
        bundle = leader.api.incidents.get(federated[-1]["id"])
        [degradation] = bundle["verdict"]["degradations"]
        assert degradation["peer"] == follower.url
        assert "fsync-stall" in degradation["peer_reasons"]
        peer_incident_id = degradation["peer_incident_id"]
        assert peer_incident_id is not None
        peer_index = requests.get(f"{follower.url}/debug/incidents",
                                  headers=ADMIN, timeout=10).json()
        assert peer_incident_id in [b["id"]
                                    for b in peer_index["incidents"]]

        # ... and embeds a non-empty pre-incident history slice
        assert bundle["history"]["series"], bundle["history"]

        # GET /debug/fleet serves the same verdict over HTTP
        over_http = requests.get(f"{leader.url}/debug/fleet",
                                 headers=ADMIN, timeout=10).json()
        assert over_http["enabled"]
        assert P.fleet.PEER_DEGRADED in over_http["reasons"]

        # "restart" the leader: a fresh history over the same dir still
        # serves the pre-restart samples
        pre_restart = leader.api.history.query("obs.health.degraded")
        assert pre_restart["series"]["obs.health.degraded"]
        leader.api.history.stop()
        reborn = P.tsdb.MetricsHistory(
            dir=leader_history_dir, config=P.tsdb.HistoryConfig(sample_s=0))
        recovered = reborn.query("obs.health.degraded")
        assert recovered["series"]["obs.health.degraded"] \
            == pre_restart["series"]["obs.health.degraded"]
        reborn.stop()
    finally:
        fleet.stop()
        leader.stop()
        follower.stop()


# ------------------------------------------------- the standby self-registers


def _wait(pred, timeout_s, what):
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        if pred():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def test_standby_self_registers_as_fleet_peer(tmp_path):
    """The replication ack doubles as fleet-peer registration: a
    standby that tails the leader lands its URL in the leader's ack
    registry, the leader's fleet observatory (started with leadership)
    discovers it with NO `peers` config, and one poll yields a healthy
    fleet row for it (the fleet-peer half of the reference's
    tests/test_replication_durability.py case, on the port)."""
    from cook_tpu_torch.components import (build_process, shutdown,
                                           start_leader_duties)
    from cook_tpu_torch.control.lease_server import LeaseServer
    from cook_tpu_torch.utils.config import Settings

    def settings(port, data_dir, lease_url):
        return Settings(
            port=port, data_dir=data_dir, platform="cpu",
            leader_endpoint=lease_url, leader_ttl_s=3.0,
            clusters=[{"kind": "mock", "name": "m1",
                       "hosts": [{"node_id": "h0", "mem": 4000,
                                  "cpus": 8}]}],
            pools=[{"name": "default"}],
            rank_interval_s=3600, match_interval_s=3600)

    free_port = port_server.free_port
    lease = LeaseServer().start()
    p1 = p2 = None
    try:
        s1 = settings(free_port(), str(tmp_path / "n1"), lease.url)
        p1 = build_process(s1)
        start_leader_duties(p1, block=False, on_loss=lambda: None)
        assert p1.is_leader()
        assert p1.fleet is not None and p1.api.fleet is p1.fleet

        s2 = settings(free_port(), str(tmp_path / "n2"), lease.url)
        p2 = build_process(s2)
        standby = threading.Thread(
            target=start_leader_duties, args=(p2,),
            kwargs={"block": False, "on_loss": lambda: None}, daemon=True)
        standby.start()
        standby_url = f"http://127.0.0.1:{s2.port}"
        _wait(lambda: standby_url in p1.fleet.peer_list(), 15,
              "standby url in the leader's fleet peer registry")

        rows = p1.fleet.poll_once()
        row = rows[standby_url]
        assert row["ok"], row
        verdict = p1.api.fleet.verdict()
        assert standby_url in [n["url"] for n in verdict["nodes"]]
        # the standby runs its own history sampler (every node role)
        assert p2.history is not None
        # served over the leader's REST surface too
        r = requests.get(f"http://127.0.0.1:{s1.port}/debug/fleet",
                         headers=ADMIN, timeout=10)
        assert r.status_code == 200
        body = r.json()
        assert body["enabled"]
        assert standby_url in [n["url"] for n in body["nodes"]]
    finally:
        for p in (p1, p2):
            if p is not None:
                shutdown(p)
        lease.stop()


# ---------------------------------------------------- across the packages


@PAIRS
def test_each_package_polls_a_control_plane_of_the_other(W, R):
    """W's observatory polls R's control plane over HTTP: a healthy row
    with the same keys and headline names either way."""
    peer = R.server.InprocessControlPlane(history_sample_s=0).start()
    try:
        fleet = W.fleet.FleetObservatory(self_url="http://leader",
                                         peers=(peer.url,), poll_s=0)
        row = fleet.poll_once()[peer.url]
        assert row["ok"] and row["healthy"], row
        assert set(row) == {"url", "polled_at", "wall_time", "ok",
                            "healthy", "status", "reasons", "contention",
                            "staleness", "headline"}
        assert set(row["contention"]) <= {"store_lock", "journal",
                                          "commit_ack"}
        assert "rest.in_flight" in row["headline"]
        verdict = fleet.verdict()
        assert verdict["healthy"] and verdict["peers"] == 1
    finally:
        peer.stop()


def test_both_packages_parse_an_exposition_alike():
    for names in (HEADLINE, ("rest.in_flight",), ()):
        assert port_fleet.parse_headline(EXPOSITION, names) == \
            ref_fleet.parse_headline(EXPOSITION, names)
    assert port_fleet.FLEET_REASONS == ref_fleet.FLEET_REASONS
    assert port_fleet.DEFAULT_HEADLINE_METRICS == \
        ref_fleet.DEFAULT_HEADLINE_METRICS
