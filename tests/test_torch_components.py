"""The port's process wiring (`cook_tpu_torch/components.py`,
`control/leader.py`, `__main__.py`) against the reference's on the CPU:
the single-process cases of tests/test_components.py on both packages
(`P` over `ref` / `port`: the electors and the selector, the reaction
wiring, a whole node booted from config and driven over HTTP), journal
recovery across a restart, a 2-shard leader's fail-stop demotion when
either journal segment fails its fsync, what waits for a later
control-plane slice refusing to start and what waited booting (a 2-shard
leader among them), the device a config names, `python -m
cook_tpu_torch` itself: booted on the CPU, stopped with SIGTERM, and
restarted on the same data_dir with every acknowledged job readable, and
`chip_smoke.py`'s service and failover phases at a CPU test's size."""
import json
import os
import signal
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import pytest
import requests
import torch

from cook_tpu import components as ref_components
from cook_tpu import faults as ref_faults
from cook_tpu.control import leader as ref_leader
from cook_tpu.models import entities as ref_ent
from cook_tpu.rest import server as ref_server
from cook_tpu.utils import config as ref_config
from cook_tpu_torch import components as port_components
from cook_tpu_torch import faults as port_faults
from cook_tpu_torch.control import leader as port_leader
from cook_tpu_torch.models import entities as port_ent
from cook_tpu_torch.rest import server as port_server
from cook_tpu_torch.utils import config as port_config

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = SimpleNamespace(name="ref", components=ref_components,
                      leader=ref_leader, server=ref_server,
                      config=ref_config, faults=ref_faults, ent=ref_ent,
                      platform={})
PORT = SimpleNamespace(name="port", components=port_components,
                       leader=port_leader, server=port_server,
                       config=port_config, faults=port_faults,
                       ent=port_ent, platform={"platform": "cpu"})
PKGS = pytest.mark.parametrize("P", [REF, PORT], ids=["ref", "port"])
H = {"X-Cook-Requesting-User": "u1"}
TIMEOUT_S = 30


def settings(P, **kw):
    return P.config.Settings(**{**P.platform, **kw})


# ------------------------------------------------------------- electors


@PKGS
def test_in_memory_single_leader(P):
    a = P.leader.InMemoryElector(f"{P.name}-g1", "a")
    b = P.leader.InMemoryElector(f"{P.name}-g1", "b")
    assert a.try_acquire() and not b.try_acquire()
    assert a.heartbeat() and not b.heartbeat()
    a.release()
    assert b.try_acquire() and b.current_leader() == "b"


@PKGS
def test_file_lease_takeover_on_staleness(P, tmp_path):
    now = [0.0]
    path = str(tmp_path / "lease")
    a = P.leader.FileLeaseElector(path, "a", ttl_s=10, clock=lambda: now[0])
    b = P.leader.FileLeaseElector(path, "b", ttl_s=10, clock=lambda: now[0])
    assert a.try_acquire() and not b.try_acquire()
    now[0] += 5
    assert a.heartbeat() and not b.try_acquire()
    now[0] += 11
    assert b.try_acquire() and not a.heartbeat()
    assert b.current_leader() == "b"


@PKGS
def test_selector_fail_fast_on_loss(P):
    group = f"{P.name}-g2"
    elector = P.leader.InMemoryElector(group, "x")
    lost = threading.Event()
    sel = P.leader.LeaderSelector(elector, poll_s=0.01, on_loss=lost.set)
    sel.wait_for_leadership()
    assert sel.is_leader
    t = sel.start_heartbeat_thread()
    P.leader.InMemoryElector._leaders[group] = "usurper"
    assert lost.wait(timeout=2)
    t.join(timeout=2)
    sel.stop()
    P.leader.InMemoryElector._leaders.pop(group, None)


@PKGS
def test_selector_demote_releases_and_fires_loss_once(P):
    group = f"{P.name}-g3"
    losses = []
    sel = P.leader.LeaderSelector(P.leader.InMemoryElector(group, "x"),
                                  poll_s=0.01,
                                  on_loss=lambda: losses.append(1))
    sel.wait_for_leadership()
    t = sel.start_heartbeat_thread()
    sel.demote()
    assert not sel.is_leader
    assert P.leader.InMemoryElector(group, "y").try_acquire()
    t.join(timeout=2)
    assert not t.is_alive()
    sel.demote()
    assert losses == [1]
    P.leader.InMemoryElector._leaders.pop(group, None)


@PKGS
def test_selector_concurrent_loss_fires_once(P):
    group = f"{P.name}-g4"
    losses = []
    barrier = threading.Barrier(8)
    sel = P.leader.LeaderSelector(P.leader.InMemoryElector(group, "x"),
                                  poll_s=0.01,
                                  on_loss=lambda: losses.append(1))
    sel.wait_for_leadership()

    def fire():
        barrier.wait()
        sel._fire_loss()

    threads = [threading.Thread(target=fire) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=2)
    assert losses == [1]
    P.leader.InMemoryElector._leaders.pop(group, None)


# ------------------------------------------------------- process wiring


def _mock_settings(P, **kw):
    return settings(P, clusters=[{
        "kind": "mock", "name": "m1",
        "hosts": [{"node_id": "h0", "mem": 4000, "cpus": 8}]}],
        pools=[{"name": "default"}], rank_interval_s=3600,
        match_interval_s=3600, **kw)


@PKGS
@pytest.mark.parametrize("shedding", [True, False], ids=["on", "off"])
def test_load_shedding_governs_both_reactions(P, shedding):
    p = P.components.build_process(_mock_settings(P, load_shedding=shedding),
                                   start_rest=False)
    try:
        if shedding:
            assert p.scheduler.admission.overload_fn == \
                p.api.shedder.overloaded
        else:
            assert p.scheduler.admission.overload_fn is None
            assert p.scheduler.admission.overloaded() is False
    finally:
        P.components.shutdown(p)


def _job_status(url, uuid):
    r = requests.get(f"{url}/jobs/{uuid}", headers=H, timeout=TIMEOUT_S)
    assert r.status_code == 200, r.text
    return r.json()["status"]


@PKGS
def test_full_process_end_to_end(P, tmp_path):
    """Boot a whole node from config: REST + leader loops + mock cluster;
    submit through HTTP; the job runs and completes as cycles fire."""
    cfg = tmp_path / "config.json"
    cfg.write_text(json.dumps({
        **P.platform,
        "pools": [{"name": "default"}],
        "clusters": [{"kind": "mock", "name": "m1", "hosts": [
            {"node_id": "h1", "mem": 4000, "cpus": 8},
            {"node_id": "h2", "mem": 4000, "cpus": 8}]}],
        "rank_interval_s": 3600, "match_interval_s": 3600}))
    s = P.config.read_config(str(cfg), {"port": P.server.free_port()})
    process = P.components.build_process(s)
    try:
        url = f"http://127.0.0.1:{s.port}"
        r = requests.post(f"{url}/jobs", json={"jobs": [
            {"command": "x", "mem": 100, "cpus": 1,
             "expected_runtime": 1000}]}, headers=H, timeout=TIMEOUT_S)
        assert r.status_code == 201, r.text
        uuid = r.json()["jobs"][0]
        P.components.start_leader_duties(process, block=False,
                                         on_loss=lambda: None)
        assert process.is_leader()
        assert requests.get(f"{url}/debug", timeout=TIMEOUT_S).json() == {
            "healthy": True, "leader": True}
        loops = {loop.name: loop for loop in process.loops}
        assert {"rank", "match", "rebalancer", "lingering", "straggler",
                "cancelled", "monitor", "heartbeats", "mock-advance",
                "health-watch"} <= set(loops)
        loops["rank"].fire()
        loops["match"].fire()
        assert _job_status(url, uuid) == "running"
        process.clusters[0].advance_to(process.store.clock() + 10_000_000)
        assert _job_status(url, uuid) == "completed"
    finally:
        P.components.shutdown(process)


@PKGS
def test_journal_recovery_across_a_restart(P, tmp_path):
    """Every acknowledged submit is journaled before its 201: a process
    built on the same data_dir reads each one back, with its state."""
    data = str(tmp_path / "data")
    s = _mock_settings(P, data_dir=data, port=P.server.free_port())
    p1 = P.components.build_process(s)
    acked = []
    try:
        url = f"http://127.0.0.1:{s.port}"
        for batch in range(3):
            r = requests.post(f"{url}/jobs", json={"jobs": [
                {"command": f"b{batch}-{i}", "mem": 100, "cpus": 1}
                for i in range(5)]}, headers=H, timeout=TIMEOUT_S)
            assert r.status_code == 201
            acked += r.json()["jobs"]
        P.components.start_leader_duties(p1, block=False,
                                         on_loss=lambda: None)
        {loop.name: loop for loop in p1.loops}["rank"].fire()
        {loop.name: loop for loop in p1.loops}["match"].fire()
        running = {u for u in acked
                   if p1.store.jobs[u].state.value == "running"}
        assert running
        killed = acked[-1]
        assert requests.delete(f"{url}/jobs", params={"job": killed},
                               headers=H, timeout=TIMEOUT_S
                               ).status_code == 204
    finally:
        P.components.shutdown(p1)
    s2 = _mock_settings(P, data_dir=data, port=P.server.free_port())
    p2 = P.components.build_process(s2)
    try:
        assert p2.store.recovered_stats["journal_replayed"] > 0
        url = f"http://127.0.0.1:{s2.port}"
        for u in acked:
            want = ("completed" if u == killed else
                    "running" if u in running else "waiting")
            assert _job_status(url, u) == want, u
    finally:
        P.components.shutdown(p2)


@pytest.mark.parametrize("conf", [
    {"peers": ("http://127.0.0.1:1",)},
    {"clusters": [{"kind": "k8s", "name": "k"}]},
    {"clusters": [{"kind": "k8s-http", "name": "k", "url": "http://x"}]},
], ids=["fleet", "k8s", "k8s-http"])
def test_what_waits_refuses_to_start(conf):
    with pytest.raises(ValueError, match="not ported yet"):
        port_components.build_process(
            settings(PORT, **conf), start_rest=False)


@pytest.mark.parametrize("case", ["file-lease", "lease-service",
                                  "sync-ack", "shards-2"])
def test_what_waited_boots_and_stops_cleanly(case, tmp_path):
    """The election, replication and sharding configs that waited for
    the control-plane slices boot now: a file lease or the lease service
    elect the first node, a second one on the lease service stands by
    with a journal follower, a sync-ack leader with no standby commits
    and says "replicated": false, a 2-shard leader commits to both
    shards' journal segments and snapshots them; every node stops with no
    thread left behind."""
    from cook_tpu_torch.control.lease_server import LeaseServer

    lease = LeaseServer().start() if case == "lease-service" else None
    conf = {"file-lease": {"leader_lease_path": str(tmp_path / "lease")},
            "lease-service": {"leader_endpoint": lease and lease.url},
            "sync-ack": {"replication_sync_ack": True,
                         "replication_ack_timeout_s": 0.2},
            "shards-2": {"shards": 2}}[case]
    nodes, threads = [], []
    try:
        for i in range(2 if lease else 1):
            s = _mock_settings(PORT, port=port_server.free_port(),
                               data_dir=str(tmp_path / f"n{i}"), **conf)
            nodes.append(port_components.build_process(s))
            t = threading.Thread(
                target=port_components.start_leader_duties,
                args=(nodes[-1],), kwargs={"block": False,
                                           "on_loss": lambda: None},
                daemon=True)
            t.start()
            threads.append(t)
            if i == 0:
                t.join(timeout=TIMEOUT_S)
                assert nodes[0].is_leader()
        url = f"http://127.0.0.1:{nodes[0].settings.port}"
        r = requests.post(f"{url}/jobs", json={"jobs": [
            {"command": "x", "mem": 100, "cpus": 1}]}, headers=H,
            timeout=TIMEOUT_S)
        assert r.status_code == 201
        assert r.json().get("replicated") is (
            False if case == "sync-ack" else None)
        if lease:
            standby = nodes[1]
            uuid = r.json()["jobs"][0]
            deadline = time.monotonic() + TIMEOUT_S
            while uuid not in standby.store.jobs:
                assert time.monotonic() < deadline, "no replication"
                time.sleep(0.05)
            assert not standby.is_leader() and threads[1].is_alive()
        if case == "shards-2":
            from cook_tpu_torch.shard import journal as shard_journal

            leader = nodes[0]
            uuid = r.json()["jobs"][0]
            assert [len(s.jobs) for s in leader.store.shards] == [1, 0]
            {loop.name: loop for loop in leader.loops}["snapshot"].fire()
            for i in range(2):
                assert os.path.exists(os.path.join(shard_journal.shard_dir(
                    leader.settings.data_dir, i), "snapshot.json"))
            assert shard_journal.read_manifest(
                leader.settings.data_dir)["shards"] == 2
    finally:
        for p in nodes:
            port_components.shutdown(p)
        for t in threads:
            t.join(timeout=TIMEOUT_S)
        if lease:
            lease.stop()
    assert not any(t.is_alive() for t in threads)
    for p in nodes:
        followers = getattr(p.follower, "followers", [p.follower])
        assert not any(f is not None and f._thread.is_alive()
                       for f in followers)
        assert not p.loops or not any(
            loop._thread.is_alive() for loop in p.loops)
    if case == "shards-2":
        from cook_tpu_torch.shard import journal as shard_journal

        recovered = shard_journal.recover_sharded(
            nodes[0].settings.data_dir, 2)
        assert set(recovered.jobs) == set(nodes[0].store.jobs) == {uuid}


@PKGS
@pytest.mark.parametrize("segment", [0, 1])
def test_fsync_failure_of_any_segment_demotes_a_sharded_leader(
        P, segment, tmp_path):
    """Under the fail-stop policy a 2-shard leader whose journal segment
    of either shard fails its fsync reports that commit undurable and
    demotes itself; the other shard's commits before it stood."""
    from cook_tpu_torch.shard import ShardRouter
    from cook_tpu_torch.shard import journal as shard_journal

    pools = ShardRouter(2).pools_for_distinct_shards()
    data = str(tmp_path / "data")
    s = settings(P, shards=2, pools=[{"name": p} for p in pools],
                 data_dir=data, journal_fsync_policy="fail-stop",
                 rank_interval_s=3600, match_interval_s=3600,
                 clusters=[{"kind": "mock", "name": "m1", "hosts": [
                     {"node_id": "h0", "mem": 4000, "cpus": 8}]}])
    p = P.components.build_process(s, start_rest=False)
    txn = p.api.txn
    try:
        P.components.start_leader_duties(p, block=False,
                                         on_loss=lambda: None)
        assert p.is_leader()
        other = pools[1 - segment]
        txn.commit("share/set", {"share": _share(P, other)})
        P.faults.arm(P.faults.FaultSchedule([P.faults.FaultRule(
            point=P.faults.JOURNAL_FSYNC, mode="error",
            match={"path": os.path.join(
                shard_journal.shard_dir(data, segment), "journal.jsonl")})]))
        with pytest.raises(OSError):
            txn.commit("share/set", {"share": _share(P, pools[segment])})
        deadline = time.monotonic() + TIMEOUT_S
        while p.is_leader():
            assert time.monotonic() < deadline, "no fail-stop demotion"
            time.sleep(0.02)
        assert p.api.leader is False and p.scheduler.active is False
        assert ("u", other) in p.store.shards[1 - segment].shares
    finally:
        P.faults.disarm()
        P.components.shutdown(p)


def _share(P, pool):
    return P.ent.Share(user="u", pool=pool,
                       resources=P.ent.Resources(mem=1.0, cpus=1.0))


def test_no_card_and_no_cpu_platform_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_components.build_process(port_config.Settings(clusters=[]),
                                      start_rest=False)


def test_scheduler_runs_on_the_named_device():
    p = port_components.build_process(_mock_settings(PORT), start_rest=False)
    try:
        assert p.scheduler.device.type == "cpu"
    finally:
        port_components.shutdown(p)


def test_shutdown_waits_for_a_running_cycle():
    p = port_components.build_process(_mock_settings(PORT), start_rest=False)
    started = threading.Event()
    done = []

    def slow():
        started.set()
        time.sleep(0.5)
        done.append(1)

    loop = port_components.TriggerLoop("slow", 0.01, slow).start()
    p.loops.append(loop)
    assert started.wait(TIMEOUT_S)
    port_components.shutdown(p)
    assert done and not loop._thread.is_alive()


# --------------------------------------------- python -m cook_tpu_torch


def _boot(cfg_path, log_path, *extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    log = open(log_path, "ab")
    proc = subprocess.Popen(
        [sys.executable, "-m", "cook_tpu_torch", "--config", cfg_path,
         *extra], cwd=REPO, env=env, stdout=log, stderr=log)
    log.close()
    return proc


def _wait_healthy(url, proc, deadline_s=60.0):
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        assert proc.poll() is None, "the service exited while booting"
        try:
            r = requests.get(f"{url}/debug", timeout=2)
            if r.status_code == 200:
                return r.json()
        except requests.RequestException:
            pass
        time.sleep(0.2)
    raise AssertionError("the service never answered /debug")


def _stop(proc):
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
        try:
            return proc.wait(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=TIMEOUT_S)
            raise
    return proc.returncode


def test_main_boots_on_the_cpu_and_acked_jobs_survive_a_restart(tmp_path):
    port = port_server.free_port()
    cfg = tmp_path / "config.json"
    cfg.write_text(json.dumps({
        "port": port, "platform": "cpu", "pools": [{"name": "default"}],
        "rank_interval_s": 0.2, "match_interval_s": 0.2,
        "data_dir": str(tmp_path / "data"),
        "clusters": [{"kind": "mock", "name": "m", "default_runtime_ms":
                      600_000, "hosts": [
                          {"node_id": f"h{i}", "mem": 8000, "cpus": 16}
                          for i in range(4)]}]}))
    url = f"http://127.0.0.1:{port}"
    log = str(tmp_path / "svc.log")
    proc = _boot(str(cfg), log)
    acked = []
    try:
        assert _wait_healthy(url, proc) == {"healthy": True, "leader": True}
        for batch in range(4):
            r = requests.post(f"{url}/jobs", json={"jobs": [
                {"command": "x", "mem": 256, "cpus": 1}
                for _ in range(25)]}, headers=H, timeout=TIMEOUT_S)
            assert r.status_code == 201
            acked += r.json()["jobs"]
        deadline = time.monotonic() + 60
        while _job_status(url, acked[0]) != "running":
            assert time.monotonic() < deadline
            time.sleep(0.2)
    finally:
        rc = _stop(proc)
    assert rc == 0, open(log).read()[-2000:]
    proc = _boot(str(cfg), log)
    try:
        _wait_healthy(url, proc)
        statuses = {_job_status(url, u) for u in acked}
        assert statuses <= {"waiting", "running", "completed"}
    finally:
        assert _stop(proc) == 0


def test_main_no_leader_serves_rest_only(tmp_path):
    port = port_server.free_port()
    cfg = tmp_path / "config.json"
    cfg.write_text(json.dumps({"platform": "cpu",
                               "pools": [{"name": "default"}]}))
    proc = _boot(str(cfg), str(tmp_path / "svc.log"), "--port", str(port),
                 "--no-leader")
    try:
        assert _wait_healthy(f"http://127.0.0.1:{port}", proc) == {
            "healthy": True, "leader": False}
    finally:
        assert _stop(proc) == 0


def test_chip_smoke_service_phase_on_cpu(monkeypatch):
    """chip_smoke.py's service phase (25) at a CPU test's size: the node
    in process behind its REST layer (4 POSTs, 3 full-window cycles, the
    reads, the store and capacity checks; on the CPU the matcher's
    `best_node` calls run the plain version and count no launch), then
    `python -m cook_tpu_torch` stopped with SIGTERM and restarted on its
    data_dir with every acked job read back."""
    import tempfile

    import chip_smoke

    monkeypatch.setattr(chip_smoke, "SERVICE_BATCHES", 4)
    monkeypatch.setattr(chip_smoke, "SERVICE_SAMPLE", 40)
    monkeypatch.setattr(chip_smoke, "SERVICE_RESTART_JOBS", 100)
    hosts, specs = chip_smoke.service_fleet(n_hosts=200, n_jobs=2000)
    with tempfile.TemporaryDirectory() as workdir:
        launches, calls = chip_smoke.service_inprocess(hosts, specs, workdir,
                                                       device="cpu")
        # the kept calls are what the card's phase holds against the
        # plain version: the matcher's own arguments, here on the CPU
        assert launches == 0 and calls
        assert all(a.device.type == "cpu" for a in calls[0][:3])
        chip_smoke.service_restart(hosts, specs, workdir, device="cpu")


def test_chip_smoke_failover_phase_on_cpu():
    """chip_smoke.py's failover phase (26) at a CPU test's size: a lease
    service and leader A (`python -m cook_tpu_torch`, sync acks) as
    subprocesses, standby B in process; 2,000 jobs in 10 sync-acked
    POSTs, each on B's disk before its 201; a replica read on B; A
    SIGKILLed, B promoted within 2 x TTL + 5 s and running 3 full-window
    cycles; every acked job read back from B, no other job there, B's
    index consistent, no host over-committed.  On the CPU the matcher's
    `best_node` calls run the plain version and count no launch."""
    import tempfile

    import chip_smoke

    hosts, specs = chip_smoke.service_fleet(n_hosts=200, n_jobs=2000)
    with tempfile.TemporaryDirectory() as workdir:
        launches, calls = chip_smoke.failover_run(hosts, specs, workdir,
                                                  device="cpu")
    assert launches == 0 and calls
    assert all(a.device.type == "cpu" for a in calls[0][:3])


def test_chip_smoke_sharded_failover_phase_on_cpu():
    """chip_smoke.py's sharded failover phase (27) at a CPU test's size: a
    lease service and a 2-shard leader A (`python -m cook_tpu_torch`, sync
    acks) as subprocesses, a 2-shard standby B in process; the fleet of
    200 hosts split into one pool per shard; 2,000 jobs in 10 sync-acked
    POSTs (the odd-numbered ones across both shards), waiting jobs moved
    to the other pool, each 201 on both of B's segments; a replica read
    on B naming both shards; A SIGKILLed, B promoted within 2 x TTL + 5 s
    and running 3 cycles with a window in each pool; every acked job read
    back from B in its acknowledged pool, on the shard that owns it, no
    other job there, B's index consistent, no host over-committed, and
    B's data_dir recovering to B's per-shard state.  On the CPU the
    matcher's `best_node` calls run the plain version and count no
    launch."""
    import tempfile

    import chip_smoke

    hosts, specs = chip_smoke.service_fleet(n_hosts=200, n_jobs=2000)
    with tempfile.TemporaryDirectory() as workdir:
        launches, calls, per_pool = chip_smoke.sharded_failover_run(
            hosts, specs, workdir, device="cpu")
    assert launches == 0 and calls
    assert set(per_pool) == set(chip_smoke.sharded_pools())
    assert all(per_pool.values()) and sum(per_pool.values()) == len(calls)
    assert all(a.device.type == "cpu" for a in calls[0][:3])
