"""Whole-process failover against the reference's on the CPU: the cases of
tests/test_process_failover.py (a node persists and dies; the next one
recovers the store from the same data_dir through a file lease) and of
tests/test_leader_http_failover.py's SIGKILL case (a lease service and
two scheduler processes with separate data directories, nothing shared but
TCP; the leader is SIGKILLed and its data dir deleted; the standby takes
the lease after the TTL and serves, schedules and accepts writes), each on
both packages (`P` over `ref` / `port`): the port's through `python -m
cook_tpu_torch.control.lease_server` and `python -m cook_tpu_torch`; and
the same SIGKILL over two shards (`"shards": 2`, sync acks): cross-shard
writes acknowledged on both of the standby's segments, the standby
promoted, every acked job read back in its pool and recovered on the
shard that owns it."""
import json
import os
import shutil
import signal
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest
import requests
import torch

from cook_tpu import components as ref_components
from cook_tpu.models import entities as ref_ent
from cook_tpu.models import persistence as ref_persist
from cook_tpu.rest import server as ref_server
from cook_tpu.utils import config as ref_config
from cook_tpu_torch import components as port_components
from cook_tpu_torch.models import entities as port_ent
from cook_tpu_torch.models import persistence as port_persist
from cook_tpu_torch.rest import server as port_server
from cook_tpu_torch.utils import config as port_config

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = SimpleNamespace(name="ref", pkg="cook_tpu", components=ref_components,
                      ent=ref_ent, persist=ref_persist, server=ref_server,
                      config=ref_config, platform={})
PORT = SimpleNamespace(name="port", pkg="cook_tpu_torch",
                       components=port_components, ent=port_ent,
                       persist=port_persist, server=port_server,
                       config=port_config, platform={"platform": "cpu"})
PKGS = pytest.mark.parametrize("P", [REF, PORT], ids=["ref", "port"])
H = {"X-Cook-Requesting-User": "u"}
TIMEOUT_S = 15
MOCK = [{"kind": "mock", "name": "m1",
         "hosts": [{"node_id": "h0", "mem": 4000, "cpus": 8}]}]


def file_lease_settings(P, tmp_path):
    return P.config.Settings(
        port=P.server.free_port(), data_dir=str(tmp_path / "data"),
        leader_lease_path=str(tmp_path / "lease"), clusters=MOCK,
        pools=[{"name": "default"}], rank_interval_s=3600,
        match_interval_s=3600, **P.platform)


@PKGS
def test_process_failover_via_snapshot(P, tmp_path):
    """Node A persists (snapshot) and dies; node B boots from the same
    data dir and file lease with A's state, and leads."""
    s1 = file_lease_settings(P, tmp_path)
    p1 = P.components.build_process(s1)
    try:
        url1 = f"http://127.0.0.1:{s1.port}"
        r = requests.post(f"{url1}/jobs", json={"jobs": [
            {"command": "x", "mem": 100, "cpus": 1,
             "uuid": "f0000000-0000-0000-0000-000000000001"},
            {"command": "y", "mem": 100, "cpus": 1,
             "uuid": "f0000000-0000-0000-0000-000000000002"},
        ]}, headers=H, timeout=TIMEOUT_S)
        assert r.status_code == 201
        P.components.start_leader_duties(p1, block=False,
                                         on_loss=lambda: None)
        loops = {loop.name: loop for loop in p1.loops}
        loops["rank"].fire()
        loops["match"].fire()
        loops["snapshot"].fire()  # persist before the "crash"
    finally:
        P.components.shutdown(p1)
    s2 = file_lease_settings(P, tmp_path)
    p2 = P.components.build_process(s2)
    try:
        url2 = f"http://127.0.0.1:{s2.port}"
        r = requests.get(f"{url2}/jobs/f0000000-0000-0000-0000-000000000001",
                         headers=H, timeout=TIMEOUT_S)
        assert r.status_code == 200
        job = r.json()
        assert job["status"] == "running"  # state survived the failover
        assert len(job["instances"]) == 1
        P.components.start_leader_duties(p2, block=False,
                                         on_loss=lambda: None)
        assert p2.is_leader()
        data_dir = s2.data_dir
        events = (P.persist.read_journal(f"{data_dir}/journal.jsonl")
                  + P.persist.read_journal(f"{data_dir}/journal.jsonl.1"))
        assert any(e["kind"] == "job/created" for e in events)
    finally:
        P.components.shutdown(p2)


@PKGS
def test_post_snapshot_writes_survive_crash(P, tmp_path):
    """Writes acknowledged AFTER the last snapshot survive through the
    journal replay."""
    s1 = file_lease_settings(P, tmp_path)
    p1 = P.components.build_process(s1)
    pre = "f0000000-0000-0000-0000-00000000000a"
    post = "f0000000-0000-0000-0000-00000000000b"
    try:
        url1 = f"http://127.0.0.1:{s1.port}"
        assert requests.post(f"{url1}/jobs", json={"jobs": [
            {"command": "x", "mem": 100, "cpus": 1, "uuid": pre},
        ]}, headers=H, timeout=TIMEOUT_S).status_code == 201
        P.components.start_leader_duties(p1, block=False,
                                         on_loss=lambda: None)
        {loop.name: loop for loop in p1.loops}["snapshot"].fire()
        assert requests.post(f"{url1}/jobs", json={"jobs": [
            {"command": "y", "mem": 100, "cpus": 1, "uuid": post,
             "application": {"name": "app", "version": "7"}},
        ]}, headers=H, timeout=TIMEOUT_S).status_code == 201
    finally:
        P.components.shutdown(p1)
    s2 = file_lease_settings(P, tmp_path)
    p2 = P.components.build_process(s2)
    try:
        assert pre in p2.store.jobs
        assert post in p2.store.jobs, "post-snapshot write lost"
        job = p2.store.jobs[post]
        assert job.state == P.ent.JobState.WAITING
        assert job.application is not None and job.application.name == "app"
        assert p2.store.recovered_stats["journal_replayed"] >= 1
        r = requests.get(f"http://127.0.0.1:{s2.port}/jobs/{post}",
                         headers=H, timeout=TIMEOUT_S)
        assert r.status_code == 200
    finally:
        P.components.shutdown(p2)


# ------------------------------------------------- three OS processes


def _wait(predicate, timeout_s, what):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            if predicate():
                return
        except requests.RequestException:
            pass
        time.sleep(0.25)
    raise AssertionError(f"timed out waiting for {what}")


def _write_config(tmp_path, P, name, port, data_dir, lease_url):
    config = {
        "port": port,
        "data_dir": data_dir,
        "leader_endpoint": lease_url,
        "leader_ttl_s": 2.0,
        "rank_interval_s": 0.5,
        "match_interval_s": 0.5,
        "platform": "cpu",
        "pools": [{"name": "default"}],
        "clusters": MOCK,
    }
    path = tmp_path / f"{P.name}-{name}.json"
    path.write_text(json.dumps(config))
    return str(path)


@PKGS
def test_sigkill_leader_promotes_standby_no_shared_fs(P, tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = []

    def spawn(*argv):
        p = subprocess.Popen([sys.executable, *argv], cwd=REPO, env=env,
                             stdout=subprocess.DEVNULL,
                             stderr=subprocess.DEVNULL)
        procs.append(p)
        return p

    lease_port = P.server.free_port()
    spawn("-m", f"{P.pkg}.control.lease_server", "--host", "127.0.0.1",
          "--port", str(lease_port))
    lease_url = f"http://127.0.0.1:{lease_port}"
    try:
        _wait(lambda: requests.get(f"{lease_url}/healthz",
                                   timeout=1).ok, 30, "lease server up")
        ports = [P.server.free_port(), P.server.free_port()]
        dirs = [str(tmp_path / "node1"), str(tmp_path / "node2")]
        nodes = []
        for i in (0, 1):
            cfg = _write_config(tmp_path, P, f"node{i}", ports[i], dirs[i],
                                lease_url)
            nodes.append(spawn("-m", P.pkg, "--config", cfg))
            if i == 0:  # node0 wins the first election
                _wait(lambda: requests.get(
                    f"http://127.0.0.1:{ports[0]}/debug",
                    timeout=1).json()["leader"], 90, "node0 leads")
        leader_port, standby_port = ports
        standby = f"http://127.0.0.1:{standby_port}"
        _wait(lambda: requests.get(f"{standby}/debug", timeout=1).ok, 90,
              "standby REST up")
        uuid = "f0000000-0000-0000-0000-0000000000aa"
        r = requests.post(f"http://127.0.0.1:{leader_port}/jobs", json={
            "jobs": [{"command": "sleep 600", "mem": 100, "cpus": 1,
                      "uuid": uuid}]}, headers=H, timeout=TIMEOUT_S)
        assert r.status_code == 201, r.text
        _wait(lambda: requests.get(f"{standby}/jobs/{uuid}", headers=H,
                                   timeout=2).status_code == 200,
              30, "standby replicated the job")
        # hard-kill the leader and burn its disk
        nodes[0].send_signal(signal.SIGKILL)
        nodes[0].wait(timeout=10)
        shutil.rmtree(dirs[0])
        _wait(lambda: requests.get(f"{standby}/debug",
                                   timeout=1).json()["leader"], 30,
              "standby promoted")
        current = requests.get(f"{lease_url}/leader?group=cook",
                               timeout=2).json()
        assert current["url"] == standby
        assert requests.get(f"{standby}/jobs/{uuid}", headers=H,
                            timeout=2).status_code == 200
        _wait(lambda: requests.get(f"{standby}/jobs/{uuid}", headers=H,
                                   timeout=2).json()["status"] == "running",
              30, "the new leader schedules the replicated job")
        r = requests.post(f"{standby}/jobs", json={"jobs": [
            {"command": "true", "mem": 50, "cpus": 1,
             "uuid": "f0000000-0000-0000-0000-0000000000ab"}]},
            headers=H, timeout=TIMEOUT_S)
        assert r.status_code == 201, r.text
    finally:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGKILL)
        for p in procs:
            p.wait(timeout=TIMEOUT_S)


def _sharded_config(tmp_path, P, name, port, data_dir, lease_url, pools,
                    **extra):
    config = {
        "port": port,
        "data_dir": data_dir,
        "leader_endpoint": lease_url,
        "leader_ttl_s": 2.0,
        "rank_interval_s": 0.5,
        "match_interval_s": 0.5,
        "platform": "cpu",
        "shards": 2,
        "pools": [{"name": pool} for pool in pools],
        "clusters": [{"kind": "mock", "name": "m1", "hosts": [
            {"node_id": f"h{i}", "mem": 4000, "cpus": 8,
             "pool": pools[i % 2]} for i in range(4)]}],
        **extra,
    }
    path = tmp_path / f"{P.name}-{name}.json"
    path.write_text(json.dumps(config))
    return str(path)


@PKGS
def test_sigkill_sharded_leader_promotes_standby(P, tmp_path):
    """Two shards, nothing shared but TCP: leader A (sync acks, one
    durable ack) takes a submit spanning both shards' pools and a
    cross-shard pool move, each 201 saying it reached standby B's
    segment of every shard it touched; A is SIGKILLed and its disk
    burned; B promotes, reads back every acked job in its acknowledged
    pool (the moved one in its new pool), schedules, and once stopped its
    data_dir recovers with each job on the shard that owns its pool."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = []

    def spawn(*argv):
        p = subprocess.Popen([sys.executable, *argv], cwd=REPO, env=env,
                             stdout=subprocess.DEVNULL,
                             stderr=subprocess.DEVNULL)
        procs.append(p)
        return p

    shard_mod = __import__(f"{P.pkg}.shard.journal", fromlist=["journal"])
    router = __import__(f"{P.pkg}.shard", fromlist=["shard"]).ShardRouter(2)
    pools = router.pools_for_distinct_shards()
    lease_port = P.server.free_port()
    spawn("-m", f"{P.pkg}.control.lease_server", "--host", "127.0.0.1",
          "--port", str(lease_port))
    lease_url = f"http://127.0.0.1:{lease_port}"
    ports = [P.server.free_port(), P.server.free_port()]
    dirs = [str(tmp_path / "node1"), str(tmp_path / "node2")]
    urls = [f"http://127.0.0.1:{port}" for port in ports]
    try:
        _wait(lambda: requests.get(f"{lease_url}/healthz",
                                   timeout=1).ok, 30, "lease server up")
        nodes = []
        for i in (0, 1):
            # A runs no match cycle in the test (its jobs stay waiting,
            # so that one can move); B schedules once it leads
            cfg = _sharded_config(
                tmp_path, P, f"node{i}", ports[i], dirs[i], lease_url, pools,
                replication_sync_ack=True, replication_min_acks=1,
                replication_ack_timeout_s=20.0,
                **({"match_interval_s": 3600.0} if i == 0 else {}))
            nodes.append(spawn("-m", P.pkg, "--config", cfg))
            if i == 0:
                _wait(lambda: requests.get(f"{urls[0]}/debug", timeout=1
                                           ).json()["leader"], 90,
                      "node0 leads")
        leader, standby = urls
        _wait(lambda: requests.get(f"{standby}/debug", timeout=1).ok, 90,
              "standby REST up")
        acked = {}
        r = requests.post(f"{leader}/jobs", json={"jobs": [
            {"command": "sleep 600", "mem": 100, "cpus": 1,
             "uuid": f"f0000000-0000-0000-0000-0000000001{i:02d}",
             "pool": pools[i % 2]} for i in range(6)]},
            headers=H, timeout=TIMEOUT_S)
        assert r.status_code == 201, r.text
        assert r.json().get("replicated") is not False
        for i, uuid in enumerate(r.json()["jobs"]):
            acked[uuid] = pools[i % 2]
        moved = next(u for u, p in acked.items() if p == pools[0])
        r = requests.post(f"{leader}/pool-move", json={
            "jobs": [moved], "pool": pools[1]},
            headers={"X-Cook-Requesting-User": "admin"}, timeout=TIMEOUT_S)
        assert r.status_code == 201 and r.json()["moved"] == [moved], r.text
        assert r.json().get("replicated") is not False
        acked[moved] = pools[1]
        nodes[0].send_signal(signal.SIGKILL)
        nodes[0].wait(timeout=10)
        shutil.rmtree(dirs[0])
        _wait(lambda: requests.get(f"{standby}/debug",
                                   timeout=1).json()["leader"], 30,
              "standby promoted")
        r = requests.get(f"{standby}/jobs", params=[
            ("uuid", u) for u in acked], headers=H, timeout=TIMEOUT_S)
        assert r.status_code == 200, r.text
        assert {j["uuid"]: j["pool"] for j in r.json()} == acked
        _wait(lambda: all(
            j["status"] == "running" for j in requests.get(
                f"{standby}/jobs", params=[("uuid", u) for u in acked],
                headers=H, timeout=2).json()), 30,
            "the new leader schedules both pools' jobs")
        nodes[1].send_signal(signal.SIGTERM)
        # the port's node shuts down on SIGTERM; the reference's installs
        # no handler and dies of the signal
        assert nodes[1].wait(timeout=TIMEOUT_S) == (
            0 if P is PORT else -signal.SIGTERM)
        recovered = shard_mod.recover_sharded(dirs[1], 2)
        assert set(recovered.jobs) == set(acked)
        for uuid, pool in acked.items():
            owner = recovered.shards[router.shard_for_pool(pool)]
            assert owner.jobs[uuid].pool == pool
            assert sum(uuid in s.jobs for s in recovered.shards) == 1
    finally:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGKILL)
        for p in procs:
            p.wait(timeout=TIMEOUT_S)
