"""The job client and the `cs` CLI of `cook_tpu_torch` against `cook_tpu`
on the CPU.

- The 20 cases of tests/test_client_cli.py, each on both packages (`P`
  over `ref` / `port`): the package's `JobClient` and `cs` against the
  package's own `CookApi` on its `ServerThread`, with the reference's
  assertions.
- The CLI case of tests/test_mp_runtime.py
  (`test_cli_renders_twopc_timeline_and_trace_waterfall`) on each
  package's in-process `MpRuntime`.
- Shard-aware direct reads against the port's mp front end with real
  worker processes: the owner is learned from X-Cook-Shard-Group, a read
  goes straight to the owning worker, and after that worker's SIGKILL
  (and its standby's adoption) the stale direct read falls back to the
  front end and the next one reaches the adopter.
- Across the packages, on the wire: each package's `cs` against each
  package's service, the same commands on the same store state; the
  four transcripts (stdout and exit codes, uuids and times masked) are
  equal.
- The port's transport alone: keep-alive reuse, a redirect followed, a
  connection error retried and then raised as `JobClientError`, a 4xx
  raised with the server's `error` field.
"""
import json
import os
import re
import signal
import time
import uuid
from types import SimpleNamespace

import pytest
import requests
import torch

from cook_tpu.client import cli as ref_cli
from cook_tpu.client import jobclient as ref_jobclient
from cook_tpu.cluster import mock as ref_mock
from cook_tpu.models import entities as ref_ent
from cook_tpu.models import store as ref_store
from cook_tpu.obs import fleet as ref_fleet
from cook_tpu.rest import api as ref_api
from cook_tpu.rest import server as ref_server
from cook_tpu.scheduler import core as ref_core
from cook_tpu_torch.client import cli as port_cli
from cook_tpu_torch.client import jobclient as port_jobclient
from cook_tpu_torch.cluster import mock as port_mock
from cook_tpu_torch.models import entities as port_ent
from cook_tpu_torch.models import store as port_store
from cook_tpu_torch.obs import fleet as port_fleet
from cook_tpu_torch.rest import api as port_api
from cook_tpu_torch.rest import server as port_server
from cook_tpu_torch.scheduler import core as port_core
from tests.conftest import FakeClock

# one intra-op thread: the suite runs several pytest-xdist workers side
# by side, and idle OpenMP threads spinning in each would crowd them
torch.set_num_threads(1)

REF = SimpleNamespace(name="ref", pkg="cook_tpu", cli=ref_cli,
                      jobclient=ref_jobclient, mock=ref_mock, ent=ref_ent,
                      store=ref_store, fleet=ref_fleet, api=ref_api,
                      server=ref_server, core=ref_core, kw={})
PORT = SimpleNamespace(name="port", pkg="cook_tpu_torch", cli=port_cli,
                       jobclient=port_jobclient, mock=port_mock,
                       ent=port_ent, store=port_store, fleet=port_fleet,
                       api=port_api, server=port_server, core=port_core,
                       kw={"device": "cpu"})
PKGS = pytest.mark.parametrize("P", [REF, PORT], ids=["ref", "port"])

TIMEOUT_S = 15


def make_server(P, n_hosts=2, mem=4096):
    clock = FakeClock()
    store = P.store.JobStore(clock=clock)
    store.set_pool(P.ent.Pool(name="default"))
    cluster = P.mock.MockCluster(
        "mock",
        [P.mock.MockHost(node_id=f"n{i}", hostname=f"n{i}", mem=mem,
                         cpus=16) for i in range(n_hosts)],
        clock=clock,
    )
    scheduler = P.core.Scheduler(store, [cluster], **P.kw)
    api = P.api.CookApi(store, scheduler, P.api.ApiConfig())
    srv = P.server.ServerThread(api).start()
    srv.P = P
    srv.clock = clock
    srv.store = store
    srv.scheduler = scheduler
    srv.cluster = cluster
    return srv


@pytest.fixture(scope="module", params=[REF, PORT], ids=["ref", "port"])
def server(request):
    srv = make_server(request.param)
    yield srv
    srv.stop()


@pytest.fixture
def client(server):
    return server.P.jobclient.JobClient(server.url, user="alice")


def cycle(server):
    pool = server.store.pools["default"]
    server.scheduler.rank_cycle(pool)
    server.scheduler.match_cycle(pool)


# ------------------------------------------- tests/test_client_cli.py


def test_client_submit_query_kill(client):
    uuids = client.submit([{"command": "echo 1"}, {"command": "echo 2"}])
    assert len(uuids) == 2
    jobs = client.query(uuids)
    assert all(j["status"] == "waiting" for j in jobs)
    client.kill(uuids)
    jobs = client.query(uuids)
    assert all(j["status"] == "completed" for j in jobs)


def test_client_wait(server, client):
    [uuid] = client.submit([{"command": "w", "expected_runtime": 10_000}])
    cycle(server)

    def sleeper(_):
        server.clock.advance(20_000)
        server.cluster.advance_to(server.clock.now_ms)

    jobs = client.wait([uuid], timeout_s=10, poll_s=0.01, sleep=sleeper)
    assert jobs[0]["status"] == "completed"


def test_client_error_handling(server, client):
    with pytest.raises(server.P.jobclient.JobClientError) as e:
        client.query_one("nonexistent-uuid")
    assert e.value.status == 404
    with pytest.raises(server.P.jobclient.JobClientError):
        client.submit([{"mem": 100}])  # no command


def test_client_retry_and_reasons(server, client):
    [uuid] = client.submit([{"command": "r", "mem": 500000, "cpus": 1}])
    client.retry(uuid, 7)
    assert client.query_one(uuid)["max_retries"] == 7
    cycle(server)
    reasons = client.unscheduled_reasons(uuid)
    assert reasons


def cli(server, *argv, user="alice"):
    return server.P.cli.main(["--config", server.cfg_path, "--user", user,
                              *argv])


@pytest.fixture
def cfg(server, tmp_path):
    p = tmp_path / "cs.json"
    p.write_text(json.dumps(
        {"clusters": [{"name": "c1", "url": server.url}]}
    ))
    server.cfg_path = str(p)
    return str(p)


def test_cli_submit_show_kill(server, cfg, capsys):
    assert cli(server, "submit", "--mem", "64", "echo", "hello") == 0
    uuid = capsys.readouterr().out.strip()
    assert cli(server, "show", uuid) == 0
    out = capsys.readouterr().out
    assert "waiting" in out and uuid in out
    assert cli(server, "kill", uuid) == 0
    capsys.readouterr()
    assert cli(server, "show", uuid) == 0
    assert "completed" in capsys.readouterr().out


def test_cli_jobs_and_usage(server, cfg, capsys):
    cli(server, "submit", "sleep 1")
    capsys.readouterr()
    assert cli(server, "jobs") == 0
    assert "c1" in capsys.readouterr().out
    assert cli(server, "usage") == 0
    assert "mem" in capsys.readouterr().out


def test_cli_unknown_uuid(server, cfg, capsys):
    assert cli(server, "show", "no-such-uuid") == 1


def test_cli_timeline(server, cfg, capsys):
    assert cli(server, "submit", "--mem", "64", "tlwork") == 0
    uuid = capsys.readouterr().out.strip()
    cycle(server)
    assert cli(server, "timeline", uuid) == 0
    out = capsys.readouterr().out
    assert uuid in out
    assert "submitted to pool default" in out
    assert "matched to" in out
    assert "launched task" in out
    assert "phases:" in out
    # --json emits the raw endpoint body
    assert cli(server, "timeline", uuid, "--json") == 0
    body = json.loads(capsys.readouterr().out)
    assert body["uuid"] == uuid
    assert [e["kind"] for e in body["events"]][0] == "submitted"


def test_cli_history_sparkline_and_index(server, cfg, capsys):
    # populate the health rollup gauge, then force two sample ticks so
    # counters/histograms have a window to difference over
    server.api.health_verdict()
    server.api.history.sample_once()
    server.api.history.sample_once()
    # no metric -> the series index
    assert cli(server, "history") == 0
    index_out = capsys.readouterr().out
    assert "obs.health" in index_out or "rest." in index_out
    # a gauge family renders a sparkline line per series
    assert cli(server, "history", "obs.health.degraded",
               "--window", "3600") == 0
    out = capsys.readouterr().out
    assert "obs.health.degraded" in out and "last=" in out
    # an unknown metric is a non-zero exit with a hint, not a traceback
    assert cli(server, "history", "no.such.metric") == 1
    assert "no points" in capsys.readouterr().err
    # --json round-trips
    assert cli(server, "history", "obs.health.degraded", "--json") == 0
    parsed = json.loads(capsys.readouterr().out)
    assert parsed["series"]


def test_cli_fleet_disabled_and_rendered(server, cfg, capsys):
    # no observatory wired -> the disabled stub, exit 0
    assert cli(server, "fleet") == 0
    assert "disabled" in capsys.readouterr().out
    server.api.fleet = server.P.fleet.FleetObservatory(
        self_url=server.url, incidents=server.api.incidents,
        self_verdict_fn=server.api.health_verdict)
    try:
        server.api.fleet.poll_once()
        assert cli(server, "fleet") == 0
        out = capsys.readouterr().out
        assert "ok" in out and server.url in out
        assert cli(server, "fleet", "--json") == 0
        parsed = json.loads(capsys.readouterr().out)
        assert parsed["enabled"] and parsed["nodes"]
    finally:
        server.api.fleet = None


@PKGS
def test_sparkline_shapes(P):
    sparkline = P.cli.sparkline
    assert sparkline([]) == ""
    assert sparkline([3.0, 3.0, 3.0]) == "▁▁▁"
    ramp = sparkline([0, 1, 2, 3, 4, 5, 6, 7])
    assert ramp[0] == "▁" and ramp[-1] == "█"
    # long series downsample to the target width
    assert len(sparkline(list(range(1000)), width=40)) == 40


def test_cli_timeline_unknown_uuid(server, cfg, capsys):
    assert cli(server, "timeline", "no-such-uuid") == 1


def test_cli_admin_share_and_quota(server, cfg, capsys):
    assert server.P.cli.main(["--config", server.cfg_path, "--user",
                              "admin", "admin", "set-share", "--for-user",
                              "zed", "--mem", "500", "--cpus", "5"]) == 0
    capsys.readouterr()
    assert server.P.cli.main(["--config", server.cfg_path, "--user",
                              "admin", "admin", "set-quota", "--for-user",
                              "zed", "--count", "4"]) == 0
    capsys.readouterr()
    assert server.store.get_share("zed", "default").mem == 500
    assert server.store.get_quota("zed", "default").count == 4


def test_debug_endpoint(server):
    r = requests.get(f"{server.url}/debug", timeout=TIMEOUT_S)
    assert r.status_code == 200
    assert r.json()["healthy"] is True


@PKGS
def test_cli_config_management(P, tmp_path, capsys):
    path = str(tmp_path / "fed.json")
    assert P.cli.main(["--config", path, "config",
                       "--add-cluster", "east", "http://e:1"]) == 0
    capsys.readouterr()
    assert P.cli.main(["--config", path, "config",
                       "--add-cluster", "west", "http://w:1"]) == 0
    capsys.readouterr()
    assert P.cli.main(["--config", path, "config"]) == 0
    out = capsys.readouterr().out
    assert "east" in out and "west" in out
    assert P.cli.main(["--config", path, "config",
                       "--remove-cluster", "east"]) == 0
    capsys.readouterr()
    assert P.cli.main(["--config", path, "config"]) == 0
    assert "east" not in capsys.readouterr().out


def test_typed_views(server, client):
    [uuid] = client.submit([{"command": "v", "expected_runtime": 5_000}])
    cycle(server)
    server.clock.advance(10_000)
    server.cluster.advance_to(server.clock.now_ms)
    [view] = client.query_views([uuid])
    assert view.uuid == uuid
    assert view.completed and view.succeeded
    assert view.last_instance.status == "success"
    assert view.last_instance.hostname.startswith("n")
    assert view.retries_remaining == 0


def test_cli_why(server, cfg, capsys):
    # a job too big for any current host waits with an explanation
    [uuid] = server.P.jobclient.JobClient(server.url, user="alice").submit(
        [{"command": "big", "mem": 9999, "cpus": 15}])
    for _ in range(2):
        cycle(server)
    assert cli(server, "why", uuid) == 0
    out = capsys.readouterr().out
    assert "waiting" in out
    assert "-" in out  # at least one reason line


def test_client_submit_gang_places_atomically(server, client):
    uuids = client.submit(
        [{"command": "gangwork", "mem": 64, "expected_runtime": 5_000}] * 2,
        gang_size=2)
    assert len(uuids) == 2
    jobs = client.query(uuids)
    assert all(j["gang_size"] == 2 for j in jobs)
    groups = {j["groups"][0] for j in jobs}
    assert len(groups) == 1, "gang members must share one group"
    cycle(server)
    jobs = client.query(uuids)
    hosts = {i["hostname"] for j in jobs for i in j["instances"]}
    assert all(j["status"] == "running" for j in jobs)
    assert len(hosts) == 2, "gang members must land on distinct hosts"
    server.clock.advance(10_000)
    server.cluster.advance_to(server.clock.now_ms)


def test_client_gang_size_batch_mismatch(server, client):
    with pytest.raises(ValueError):
        client.submit([{"command": "x"}], gang_size=3)
    # server-side: gang_size without a group is rejected
    with pytest.raises(server.P.jobclient.JobClientError):
        client.submit([{"command": "x", "gang_size": 2},
                       {"command": "x", "gang_size": 2}])


def test_cli_submit_gang_timeline_renders_wait(server, cfg, capsys):
    # a 3-gang on a 2-host fleet can never assemble: the timeline must
    # attribute the wait to gang-incomplete with the best-block detail
    assert cli(server, "submit", "--gang-size", "3", "--mem", "64",
               "gangwait") == 0
    uuids = capsys.readouterr().out.split()
    assert len(uuids) == 3
    for _ in range(3):
        cycle(server)
    assert cli(server, "timeline", uuids[0]) == 0
    out = capsys.readouterr().out
    assert "gang-incomplete" in out
    assert "hosts free" in out


# ------------------------- tests/test_mp_runtime.py's CLI case, both


HDRS = {"X-Cook-Requesting-User": "alice"}


def job_spec(uuid, pool, command="true"):
    return {"uuid": uuid, "command": command, "pool": pool,
            "mem": 64, "cpus": 1}


@PKGS
def test_cli_renders_twopc_timeline_and_trace_waterfall(P, tmp_path,
                                                        capsys):
    """`cs timeline` names the 2PC hop and `cs trace` renders the
    merged cross-process waterfall when pointed at the mp front end."""
    supervisor = __import__(f"{P.pkg}.mp.supervisor",
                            fromlist=["MpRuntime"])
    runtime = supervisor.MpRuntime(n_groups=2, standbys=0, inprocess=True,
                                   poll_s=30.0)
    try:
        cfg = tmp_path / "cs.json"
        cfg.write_text(json.dumps(
            {"clusters": [{"name": "mp", "url": runtime.url}]}))
        txn_id = "cli-mp-trace"
        resp = requests.post(
            f"{runtime.url}/jobs",
            headers={**HDRS, "X-Cook-Txn-Id": txn_id},
            json={"jobs": [job_spec("cli-a", runtime.pools[1]),
                           job_spec("cli-b", runtime.pools[2])]},
            timeout=TIMEOUT_S)
        assert resp.status_code == 201
        assert P.cli.main(["--config", str(cfg), "--user", "alice",
                           "timeline", "cli-a"]) == 0
        out = capsys.readouterr().out
        assert "2PC commit decision across groups" in out
        assert "2PC done across groups" in out
        assert P.cli.main(["--config", str(cfg), "--user", "alice",
                           "trace", txn_id]) == 0
        out = capsys.readouterr().out
        for process in ("frontend", "coordinator", "worker-g"):
            assert process in out, f"{process} track missing from waterfall"
        assert "mp.submit_2pc" in out and "twopc.decision_write" in out
        assert "█" in out  # bars, not just labels
        # --json round-trips the merged raw body
        assert P.cli.main(["--config", str(cfg), "--user", "alice",
                           "trace", txn_id, "--json"]) == 0
        parsed = json.loads(capsys.readouterr().out)
        assert parsed["spans"] and parsed["cluster"] == "mp"
        # an unknown txn id exits non-zero with a retention hint
        assert P.cli.main(["--config", str(cfg), "--user", "alice",
                           "trace", "never-seen"]) == 1
        assert "no spans" in capsys.readouterr().err
    finally:
        runtime.stop()


# ---------------- shard-aware direct reads on the port's mp front end


class RecordingSession(port_jobclient.Session):
    """The port's Session, noting each request's method and url."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def request(self, method, url, **kw):
        self.calls.append((method, url))
        return super().request(method, url, **kw)


def _wait_until(what, timeout_s, probe):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        value = probe()
        if value:
            return value
        time.sleep(0.1)
    raise AssertionError(f"timed out waiting for {what}")


def test_direct_reads_learn_owner_and_fall_back_after_sigkill(tmp_path):
    from cook_tpu_torch.mp import read_route_map
    from cook_tpu_torch.mp.supervisor import MpRuntime

    runtime = MpRuntime(n_groups=2, standbys=1, poll_s=0.2,
                        data_dir=str(tmp_path / "data"))
    try:
        session = RecordingSession()
        client = port_jobclient.JobClient(
            runtime.url, user="alice", session=session, direct_reads=True)
        pool = runtime.pools[1]
        [uuid] = client.submit([{"command": "true", "mem": 64, "cpus": 1,
                                 "pool": pool}])
        group = runtime.supervisor.topology.group_for_pool(pool)
        # the owner is learned from the submit's X-Cook-Shard-Group
        assert client._uuid_group == {uuid: group}
        old = runtime.supervisor.workers[group].describe
        # a read goes straight to the owning worker, not the front end
        session.calls.clear()
        assert client.query_one(uuid)["uuid"] == uuid
        reads = [url for _, url in session.calls
                 if "/debug/shards" not in url]
        assert reads == [f"{old['url']}/jobs/{uuid}"], session.calls
        assert client.query([uuid])[0]["pool"] == pool
        # SIGKILL the owner; once the standby has adopted its segments
        # and the front end reads the new map, the client's cached map
        # still names the dead worker
        os.kill(old["pid"], signal.SIGKILL)
        new_map = _wait_until(
            "adoption in the route map", 30,
            lambda: (lambda m: m if m["groups"][group]["alive"]
                     and m["groups"][group]["url"] != old["url"]
                     else None)(read_route_map(runtime.supervisor.map_path)))
        _wait_until("the front end on the new map", 10, lambda: requests.get(
            f"{runtime.url}/debug/shards", headers=HDRS,
            timeout=TIMEOUT_S).json()["map_seq"] == new_map["map_seq"])
        session.calls.clear()
        assert client.query_one(uuid)["uuid"] == uuid
        urls = [url for _, url in session.calls]
        # the direct read failed on the dead worker, then the front end
        # answered
        assert urls[0] == f"{old['url']}/jobs/{uuid}"
        assert urls[-1] == f"{runtime.url}/jobs/{uuid}"
        assert client._uuid_group == {uuid: group}  # re-learned
        # the next read refetches the map and reaches the adopter
        session.calls.clear()
        assert client.query_one(uuid)["uuid"] == uuid
        adopter = new_map["groups"][group]["url"]
        assert session.calls[-1] == ("GET", f"{adopter}/jobs/{uuid}")
    finally:
        runtime.stop()


# ------------------------------------- each package's cs, each service


UUID_RE = re.compile(
    r"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{12}")
# wall-clock stamps (ms or s since the epoch) and ports
STAMP_RE = re.compile(r"\b1[0-9]{12}\b|\b1[0-9]{9}\.[0-9]+")
PORT_RE = re.compile(r"127\.0\.0\.1:[0-9]+")


def mask(text: str) -> str:
    """uuids numbered in order of first appearance, epoch stamps and
    ports masked."""
    seen: dict[str, str] = {}

    def number(m):
        return seen.setdefault(m.group(0), f"<uuid{len(seen)}>")

    text = UUID_RE.sub(number, text)
    text = STAMP_RE.sub("<t>", text)
    return PORT_RE.sub("<host>", text)


def cross_transcript(C, S, tmp_path, capsys, monkeypatch) -> list:
    """Package C's `cs` against package S's service, one script: its
    commands' exit codes and masked stdout and stderr.  The client's
    uuids are numbered from 1, so that the service lists and names the
    jobs (and their task ids) alike in every run."""
    minted = iter(range(1, 1000))
    monkeypatch.setattr(C.jobclient.uuid_mod, "uuid4",
                        lambda: uuid.UUID(int=next(minted)))
    srv = make_server(S)
    try:
        cfg = tmp_path / f"cs-{C.name}-{S.name}.json"
        cfg.write_text(json.dumps(
            {"clusters": [{"name": "c1", "url": srv.url}]}))
        out = []

        def run(*argv, user="alice"):
            rc = C.cli.main(["--config", str(cfg), "--user", user, *argv])
            got = capsys.readouterr()
            out.append((argv[0], rc, mask(got.out), mask(got.err)))
            return got.out

        a = run("submit", "--mem", "64", "--name", "small", "echo", "hi")
        b = run("submit", "--mem", "9999", "--cpus", "15", "--name", "big",
                "too big").strip()
        g = run("submit", "--copies", "2", "--mem", "512", "--cpus", "2",
                "--priority", "70", "--env", "K=V", "pair").split()
        a = a.strip()
        run("show", a, b, *g)
        run("show", "--json", a)
        for _ in range(2):
            cycle(srv)
        run("show", a, b, *g)
        run("jobs")
        run("jobs", "--state", "running")
        run("usage")
        run("why", b)
        run("why", a)
        run("timeline", a)
        run("timeline", b)
        run("timeline", "--json", a)
        run("retry", a, "--retries", "3")
        run("show", "--json", a)
        run("fairness")
        run("fleet")
        run("kill", b)
        run("show", b)
        run("timeline", b)
        srv.clock.advance(600_000)
        srv.cluster.advance_to(srv.clock.now_ms)
        run("wait", a, *g, "--timeout", "10")
        run("show", a)
        run("show", "no-such-uuid")
        run("kill", a, user="mallory")
        run("admin", "set-share", "--for-user", "zed", "--mem", "500",
            "--cpus", "5", user="admin")
        run("admin", "set-quota", "--for-user", "zed", "--count", "4",
            user="admin")
        run("admin", "set-share", "--for-user", "zed", "--mem", "500")
        run("trace", "never-seen")
        return out
    finally:
        srv.stop()


def test_each_cs_prints_the_same_against_each_service(tmp_path, capsys,
                                                     monkeypatch):
    transcripts = {
        (C.name, S.name): cross_transcript(C, S, tmp_path, capsys,
                                           monkeypatch)
        for C in (REF, PORT) for S in (REF, PORT)}
    want = transcripts[("ref", "ref")]
    # the script did what it says (and not by erring everywhere)
    out = {cmd: "".join(o for c, _, o, _ in want if c == cmd)
           for cmd, _, _, _ in want}
    assert [rc for cmd, rc, _, _ in want if cmd == "submit"] == [0, 0, 0]
    assert "matched to n0" in out["timeline"]
    assert "exceeds-pool-capacity" in out["why"]
    assert "success   host n0" in out["show"]
    assert out["wait"] == "completed\n" and "killed" in out["kill"]
    assert "jain 1.000" in out["fairness"]
    for key, got in transcripts.items():
        for step, (g, w) in enumerate(zip(got, want)):
            assert g == w, (key, step)
        assert len(got) == len(want)


# --------------------------------------------- the port's transport


def test_port_session_keeps_alive_follows_redirects_and_retries(tmp_path):
    from cook_tpu_torch.rest.http import (Application,
                                          HTTPTemporaryRedirect,
                                          json_response)

    seen = []

    class App:
        def build_app(self):
            app = Application()

            def hello(request):
                seen.append(request.headers.get("X-Cook-Requesting-User"))
                return json_response({"jobs": ["u1"]}, status=201)

            def moved(request):
                raise HTTPTemporaryRedirect("/jobs")

            def bad(request):
                return json_response({"error": "nope"}, status=400)

            app.router.add_post("/jobs", hello)
            app.router.add_post("/moved", moved)
            app.router.add_get("/bad", bad)
            return app

    srv = port_server.ServerThread(App()).start()
    try:
        session = port_jobclient.Session()
        client = port_jobclient.JobClient(srv.url, user="bob",
                                          session=session)
        assert client.submit([{"command": "x"}]) == ["u1"]
        assert client.submit([{"command": "x"}]) == ["u1"]
        # one keep-alive connection carried both
        assert sum(len(v) for v in session._idle.values()) == 1
        # a 307 resends the POST with its body to the Location
        resp = session.post(f"{srv.url}/moved", json={"jobs": []},
                            headers={"X-Cook-Requesting-User": "carol"})
        assert resp.status_code == 201 and resp.json() == {"jobs": ["u1"]}
        assert seen == ["bob", "bob", "carol"]
        # a 4xx raises with the server's error field
        with pytest.raises(port_jobclient.JobClientError) as e:
            client._request("GET", "/bad")
        assert e.value.status == 400 and str(e.value) == "nope"
    finally:
        srv.stop()
    # the server is gone: connection errors retried, then raised
    client = port_jobclient.JobClient(srv.url, retries=2,
                                      retry_backoff_s=0.01)
    t0 = time.monotonic()
    with pytest.raises(port_jobclient.JobClientError,
                       match="failed after 2 tries"):
        client.query(["u1"])
    assert time.monotonic() - t0 < 5


# --------------------------- chip_smoke.py's clients phase on the CPU


def test_chip_smoke_clients_phase_on_cpu(tmp_path):
    """chip_smoke.py's clients phase (29) at a CPU test's size (200
    open-loop jobs on 40 hosts, 20 through the loadgen subprocess): every
    job completed, `cs` and the loadgen CLI exit 0, the worker pool and
    the Spark fleet scale, and `cs cat` / `tail` return the executor's
    stdout byte for byte through the sidecar."""
    import chip_smoke

    hosts, _ = chip_smoke.service_fleet(n_hosts=40, n_jobs=10)
    launches, calls, summary = chip_smoke.clients_run(
        str(tmp_path), hosts, n_jobs=200, cli_jobs=20, device="cpu")
    assert summary["open_loop"]["completed"] == 200
    assert summary["loadgen_cli"]["completed"] == 20
    assert summary["sandbox"]["cat"] == "byte-equal"
    # on the CPU the wrapper runs the plain version and counts nothing,
    # but the matcher called it
    assert launches == 0 and calls


def test_package_lazy_attributes_match_the_reference():
    """`cook_tpu_torch`'s lazy exports are the reference's names, each the
    port's own class."""
    import cook_tpu
    import cook_tpu_torch
    from cook_tpu_torch.models import entities, store
    from cook_tpu_torch.scheduler.core import Scheduler
    from cook_tpu_torch.sim.simulator import Simulator

    names = ("JobStore", "Job", "Instance", "Pool", "Resources",
             "Scheduler", "JobClient", "Simulator")
    for name in names:
        assert getattr(cook_tpu, name).__name__ == name
    assert cook_tpu_torch.JobClient is port_jobclient.JobClient
    assert cook_tpu_torch.JobStore is store.JobStore
    assert cook_tpu_torch.Job is entities.Job
    assert cook_tpu_torch.Scheduler is Scheduler
    assert cook_tpu_torch.Simulator is Simulator
    with pytest.raises(AttributeError, match="no attribute 'Nope'"):
        cook_tpu_torch.Nope
