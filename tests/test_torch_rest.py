"""The REST service of `cook_tpu_torch` against `cook_tpu` on the CPU.

The port serves the reference's handlers on the standard library
(`rest/http.py`, `rest/server.py`); the reference serves them on aiohttp.
Every case here runs against both servers, each over a real socket on
127.0.0.1 and a `FakeClock`:

- tests/test_rest_api.py, test_auth_limits.py and test_health_endpoint.py,
  the cases that touch a ported route, on each package (`P` over
  `ref` / `port`);
- the REST cases earlier slices of the port left out: /debug/predictions
  (tests/test_prediction.py), /debug/elastic and /metrics
  (tests/test_elastic.py), /debug/incidents, /debug/history,
  /debug/faults, /debug/profile and the shedder's 429;
- request scripts whose transcripts (status codes and JSON bodies, with
  generated uuids and wall times normalised) must be equal between the
  two servers;
- the routes that wait for the control-plane slice answer 404 on the
  port, and the shim's concurrency rule (one loop lock, released around
  the commit pipeline).

Every request carries a timeout, so a hung handler fails its test."""
import base64
import importlib
import json
import re
import threading
import time
from types import SimpleNamespace

import pytest
import requests
import torch

from cook_tpu import components as ref_components
from cook_tpu import elastic as ref_elastic
from cook_tpu import faults as ref_faults
from cook_tpu.cluster import mock as ref_mock
from cook_tpu.models import entities as ref_ent
from cook_tpu.models import store as ref_store
from cook_tpu.obs import telemetry as ref_telemetry
from cook_tpu.ops import common as ref_common
from cook_tpu.rest import api as ref_api
from cook_tpu.rest import auth as ref_auth
from cook_tpu.rest import server as ref_server
from cook_tpu.scheduler import core as ref_core
from cook_tpu.scheduler import plugins as ref_plugins
from cook_tpu.scheduler import ratelimit as ref_ratelimit
from cook_tpu.utils import metrics as ref_metrics
from cook_tpu_torch import components as port_components
from cook_tpu_torch import elastic as port_elastic
from cook_tpu_torch import faults as port_faults
from cook_tpu_torch.cluster import mock as port_mock
from cook_tpu_torch.models import entities as port_ent
from cook_tpu_torch.models import store as port_store
from cook_tpu_torch.obs import telemetry as port_telemetry
from cook_tpu_torch.ops import common as port_common
from cook_tpu_torch.rest import api as port_api
from cook_tpu_torch.rest import auth as port_auth
from cook_tpu_torch.rest import server as port_server
from cook_tpu_torch.scheduler import core as port_core
from cook_tpu_torch.scheduler import plugins as port_plugins
from cook_tpu_torch.scheduler import ratelimit as port_ratelimit
from cook_tpu_torch.utils import metrics as port_metrics
from tests.conftest import FakeClock

# one intra-op thread: the suite runs several pytest-xdist workers side
# by side, and idle OpenMP threads spinning in each would crowd them
torch.set_num_threads(1)

REF = SimpleNamespace(name="ref", api=ref_api, server=ref_server,
                      auth=ref_auth, core=ref_core, mock=ref_mock,
                      ent=ref_ent, store=ref_store, plugins=ref_plugins,
                      telemetry=ref_telemetry, common=ref_common,
                      components=ref_components, faults=ref_faults,
                      ratelimit=ref_ratelimit, metrics=ref_metrics,
                      elastic=ref_elastic, kw={})
PORT = SimpleNamespace(name="port", api=port_api, server=port_server,
                       auth=port_auth, core=port_core, mock=port_mock,
                       ent=port_ent, store=port_store, plugins=port_plugins,
                       telemetry=port_telemetry, common=port_common,
                       components=port_components, faults=port_faults,
                       ratelimit=port_ratelimit, metrics=port_metrics,
                       elastic=port_elastic, kw={"device": "cpu"})
PKGS = pytest.mark.parametrize("P", [REF, PORT], ids=["ref", "port"])

TIMEOUT_S = 30


def hdr(user="alice"):
    return {"X-Cook-Requesting-User": user}


def call(srv, method, path, *, user="alice", headers=None, **kw):
    """One request with a timeout; the body as JSON when it parses."""
    h = hdr(user) if user else {}
    h.update(headers or {})
    r = requests.request(method, f"{srv.url}{path}", headers=h,
                         timeout=TIMEOUT_S, allow_redirects=False, **kw)
    try:
        body = r.json()
    except ValueError:
        body = r.text
    return r.status_code, body, r


def mk_job(P, user="alice", pool="default", mem=100.0, cpus=1.0, gpus=0.0,
           priority=50, max_retries=1, **kw):
    """tests/conftest.make_job in package P."""
    return P.ent.Job(uuid=P.ent.new_uuid(), user=user, pool=pool,
                     priority=priority, max_retries=max_retries,
                     resources=P.ent.Resources(mem=mem, cpus=cpus, gpus=gpus),
                     command="true", **kw)


def make_rig(P, *, n_hosts=4, pools=("default", "gpu-pool"), config=None,
             api_config=None, plugins=None, start=True):
    clock = FakeClock()
    store = P.store.JobStore(clock=clock)
    for name in pools:
        store.set_pool(P.ent.Pool(name=name))
    cluster = P.mock.MockCluster(
        "mock",
        [P.mock.MockHost(node_id=f"n{i}", hostname=f"n{i}", mem=4096,
                         cpus=16) for i in range(n_hosts)],
        clock=clock)
    scheduler = P.core.Scheduler(store, [cluster], config, plugins=plugins,
                                 **P.kw)
    api = P.api.CookApi(store, scheduler,
                        api_config or P.api.ApiConfig(admins=("admin",)),
                        plugins=plugins)
    srv = P.server.ServerThread(api)
    if start:
        srv.start()
    return SimpleNamespace(P=P, clock=clock, store=store, cluster=cluster,
                           scheduler=scheduler, api=api, srv=srv,
                           url=srv.url)


@pytest.fixture
def rigs():
    """Started rigs, stopped after the test whatever its outcome."""
    made = []

    def make(P, **kw):
        rig = make_rig(P, **kw)
        made.append(rig)
        return rig

    yield make
    for rig in made:
        rig.srv.stop()


@pytest.fixture(autouse=True)
def _disarmed():
    for f in (ref_faults, port_faults):
        f.disarm()
    yield
    for f in (ref_faults, port_faults):
        f.disarm()


def cycle(rig, pool="default"):
    p = rig.store.pools[pool]
    rig.scheduler.rank_cycle(p)
    return rig.scheduler.match_cycle(p)


def submit(rig, jobs, user="alice", groups=None, expect=201):
    body = {"jobs": jobs}
    if groups:
        body["groups"] = groups
    status, out, _ = call(rig.srv, "POST", "/jobs", user=user, json=body)
    assert status == expect, out
    return out


# ---------------------------------------------- tests/test_rest_api.py


@PKGS
def test_submit_query_kill_and_impersonation(P, rigs):
    rig = rigs(P)
    uuid = "11111111-0000-0000-0000-000000000001"
    out = submit(rig, [{"command": "echo hi", "mem": 100, "cpus": 1,
                        "uuid": uuid}])
    assert out["jobs"] == [uuid]
    status, job, _ = call(rig.srv, "GET", f"/jobs/{uuid}")
    assert status == 200 and job["status"] == "waiting"
    assert job["user"] == "alice" and job["mem"] == 100
    _, jobs, _ = call(rig.srv, "GET", "/jobs", params={"user": "alice"})
    assert any(j["uuid"] == uuid for j in jobs)
    # validation errors
    submit(rig, [{"mem": 100, "cpus": 1}], expect=400)
    submit(rig, [{"command": "x", "mem": -5}], expect=400)
    submit(rig, [{"command": "x", "cpus": 99999}], expect=400)
    submit(rig, [{"command": "x", "priority": 500}], expect=400)
    submit(rig, [{"command": "x", "pool": "nope"}], expect=400)
    assert call(rig.srv, "POST", "/jobs", json={"jobs": []})[0] == 400
    submit(rig, [{"command": "x", "uuid": uuid}], expect=400)  # duplicate
    # kill authz: another user may not, an admin may
    bob = submit(rig, [{"command": "sleep"}], user="bob")["jobs"][0]
    assert call(rig.srv, "DELETE", "/jobs", params={"job": bob})[0] == 403
    assert call(rig.srv, "DELETE", "/jobs", user="admin",
                params={"job": bob})[0] == 204
    assert call(rig.srv, "GET", f"/jobs/{bob}")[1]["status"] == "completed"
    carol = submit(rig, [{"command": "sleep"}], user="carol")["jobs"][0]
    imp = {"X-Cook-Impersonate": "carol"}
    assert call(rig.srv, "DELETE", "/jobs", user="admin", headers=imp,
                params={"job": carol})[0] == 204
    assert call(rig.srv, "GET", "/jobs", user="bob", headers=imp,
                params={"user": "carol"})[0] == 403


@PKGS
def test_share_quota_retry_and_groups(P, rigs):
    rig = rigs(P)
    srv = rig.srv
    assert call(srv, "POST", "/share", user="admin", json={
        "user": "default", "share": {"mem": 1000, "cpus": 10,
                                     "gpus": 1}})[0] == 201
    assert call(srv, "GET", "/share", params={"user": "dave"})[1]["mem"] \
        == 1000
    assert call(srv, "POST", "/quota", user="admin", json={
        "user": "dave", "quota": {"count": 3, "mem": 500, "cpus": 5}})[0] \
        == 201
    assert call(srv, "GET", "/quota", params={"user": "dave"})[1]["count"] \
        == 3
    assert call(srv, "DELETE", "/quota", user="admin",
                params={"user": "dave"})[0] == 204
    uuid = submit(rig, [{"command": "x", "max_retries": 1}])["jobs"][0]
    assert call(srv, "GET", "/retry", params={"job": uuid})[1] == 1
    assert call(srv, "POST", "/retry", json={"job": uuid,
                                             "retries": 5})[0] == 201
    assert call(srv, "PUT", "/retry", json={"jobs": [uuid],
                                            "increment": 2})[0] == 201
    assert call(srv, "GET", "/retry", params={"job": uuid})[1] == 7
    guuid = "33333333-0000-0000-0000-000000000003"
    submit(rig, [{"command": "x", "group": guuid},
                 {"command": "y", "group": guuid}],
           groups=[{"uuid": guuid, "host_placement": {"type": "unique"}}])
    _, groups, _ = call(srv, "GET", "/group",
                        params=[("uuid", guuid), ("detailed", "true")])
    g = groups[0]
    assert g["host_placement"]["type"] == "unique"
    assert len(g["jobs"]) == 2 and g["composition"]["waiting"] == 2
    assert call(srv, "DELETE", "/group", params={"uuid": guuid})[0] == 204


@PKGS
def test_full_lifecycle_progress_usage_and_stats(P, rigs):
    rig = rigs(P)
    srv = rig.srv
    uuid = submit(rig, [{"command": "work", "mem": 100, "cpus": 1,
                         "expected_runtime": 50_000}])["jobs"][0]
    cycle(rig)
    _, job, _ = call(srv, "GET", f"/jobs/{uuid}")
    assert job["status"] == "running" and len(job["instances"]) == 1
    inst = job["instances"][0]
    assert inst["status"] == "running"
    assert call(srv, "POST", f"/progress/{inst['task_id']}", json={
        "progress_percent": 50, "progress_message": "half"})[0] == 202
    assert call(srv, "GET", f"/progress/{inst['task_id']}")[1] == {
        "progress": 50, "progress_message": "half"}
    assert call(srv, "GET", "/usage", params={"user": "alice"})[1][
        "total_usage"]["jobs"] >= 1
    status, body, _ = call(srv, "GET", f"/instances/{inst['task_id']}")
    assert status == 200 and body["job"]["uuid"] == uuid
    assert len(call(srv, "GET", "/running")[1]) == 1
    assert call(srv, "GET", "/list", params={"user": "alice",
                                            "state": "running"})[1][0][
        "uuid"] == uuid
    rig.clock.advance(60_000)
    rig.cluster.advance_to(rig.clock.now_ms)
    _, job, _ = call(srv, "GET", f"/jobs/{uuid}")
    assert job["status"] == "completed"
    assert job["instances"][0]["status"] == "success"
    # a failed instance shows up by reason in the stats
    uuid2 = submit(rig, [{"command": "s", "mem": 100, "cpus": 1,
                          "max_retries": 1}])["jobs"][0]
    cycle(rig)
    [inst2] = rig.store.job_instances(uuid2)
    rig.clock.advance(5000)
    rig.cluster.fail_task(inst2.task_id, "container-limitation-memory")
    stats = call(srv, "GET", "/stats/instances")[1]
    assert stats["by-reason"]["container-limitation-memory"] == 1
    assert stats["by-status"] == {"success": 1, "failed": 1}
    assert stats["run-time-ms"]["count"] == 2


@PKGS
def test_unscheduled_reasons_and_queue(P, rigs):
    rig = rigs(P)
    submit(rig, [{"command": "x", "mem": 999999999, "cpus": 1}], expect=400)
    uuid = submit(rig, [{"command": "x", "mem": 400000,
                         "cpus": 400}])["jobs"][0]
    cycle(rig)
    _, out, _ = call(rig.srv, "GET", "/unscheduled_jobs",
                     params={"job": uuid})
    reasons = out[0]["reasons"]
    assert any("placed" in x["reason"] or "queue" in x["reason"]
               for x in reasons), reasons
    assert out[0]["starvation"]["job_wait_s"] == 0.0
    submit(rig, [{"command": "q", "mem": 100, "cpus": 1}])
    rig.scheduler.rank_cycle(rig.store.pools["default"])
    _, queue, _ = call(rig.srv, "GET", "/queue")
    # the job no host could hold is quarantined out of the ranked queue
    assert [j["uuid"] for j in queue["default"]] != [uuid]
    assert len(queue["default"]) == 1


@PKGS
def test_info_pools_settings_reasons_metrics(P, rigs):
    rig = rigs(P)
    submit(rig, [{"command": "m"}])
    srv = rig.srv
    assert call(srv, "GET", "/info")[0] == 200
    pools = call(srv, "GET", "/pools")[1]
    assert {p["name"] for p in pools} == {"default", "gpu-pool"}
    settings = call(srv, "GET", "/settings")[1]
    assert "max-job-mem" in settings
    assert settings["matcher"] == {
        "backend": "xla", "chunk": 0, "rounds": 3, "passes": 2, "kc": 128,
        "backend_batched": "xla", "quality_audit_every": 50}
    reasons = call(srv, "GET", "/failure_reasons")[1]
    assert any(r["code"] == 1002 and r["mea_culpa"] for r in reasons)
    status, text, r = call(srv, "GET", "/metrics")
    assert status == 200 and "cook_jobs_submitted" in text
    assert r.headers["Content-Type"].startswith("text/plain")


@PKGS
def test_compute_clusters_crud(P, rigs):
    rig = rigs(P)
    srv = rig.srv
    configs = call(srv, "GET", "/compute-clusters")[1]["in-mem-configs"]
    assert configs == [{"name": "mock", "state": "running",
                        "accepts-work": True}]
    assert call(srv, "POST", "/compute-clusters", user="bob", json={
        "name": "mock", "state": "draining"})[0] == 403
    assert call(srv, "POST", "/compute-clusters", user="admin", json={
        "name": "mock", "state": "draining"})[0] == 201
    assert not rig.scheduler.clusters[0].accepts_work
    assert call(srv, "POST", "/compute-clusters", user="admin", json={
        "name": "mock", "state": "running"})[0] == 201
    # creation: a cluster only it can hold a job for
    status, body, _ = call(srv, "POST", "/compute-clusters", user="admin",
                           json={"kind": "mock", "name": "burst",
                                 "hosts": [{"node_id": "bx0", "mem": 9000,
                                            "cpus": 64}]})
    assert status == 201, body
    uuid = submit(rig, [{"command": "big", "mem": 8500,
                         "cpus": 48}])["jobs"][0]
    cycle(rig)
    [inst] = rig.store.job_instances(uuid)
    assert inst.compute_cluster == "burst"
    assert call(srv, "POST", "/compute-clusters", user="admin", json={
        "kind": "nope", "name": "x"})[0] == 400
    assert call(srv, "DELETE", "/compute-clusters/burst",
                user="admin")[0] == 400     # running -> deleted refused
    assert call(srv, "POST", "/compute-clusters", user="admin", json={
        "name": "burst", "state": "draining"})[0] == 201
    assert call(srv, "DELETE", "/compute-clusters/burst",
                user="admin")[0] == 204
    assert call(srv, "DELETE", "/compute-clusters/none",
                user="admin")[0] == 404


@PKGS
def test_container_application_checkpoint_parsing(P, rigs):
    rig = rigs(P)
    out = submit(rig, [{
        "command": "x",
        "container": {"type": "DOCKER", "docker": {"image": "repo/img:v1"}},
        "application": {"name": "spark", "version": "3.0"},
        "checkpoint": {"mode": "auto", "location": "us-east"},
    }])
    job = rig.store.jobs[out["jobs"][0]]
    assert job.container.image == "repo/img:v1"
    assert job.application.name == "spark"
    assert job.checkpoint.location == "us-east"
    assert call(rig.srv, "GET", f"/jobs/{job.uuid}")[1]["application"] == {
        "name": "spark", "version": "3.0",
        "workload-class": "", "workload-id": ""}


@PKGS
def test_cancel_instance_endpoint(P, rigs):
    rig = rigs(P)
    uuid = submit(rig, [{"command": "c", "mem": 100, "cpus": 1,
                         "max_retries": 3}])["jobs"][0]
    cycle(rig)
    [inst] = rig.store.job_instances(uuid)
    assert call(rig.srv, "DELETE", "/instances", user="eve",
                params={"instance": inst.task_id})[0] == 403
    assert call(rig.srv, "DELETE", "/instances",
                params={"instance": inst.task_id})[0] == 204
    assert rig.store.instances[inst.task_id].status.value == "failed"
    assert rig.store.jobs[uuid].state.value == "waiting"


@PKGS
def test_malformed_json_swagger_and_cors(P, rigs):
    rig = rigs(P)
    srv = rig.srv
    status, body, _ = call(srv, "POST", "/jobs", data="{bad")
    assert status == 400 and "malformed" in body["error"]
    spec = call(srv, "GET", "/swagger-docs")[1]
    assert spec["openapi"].startswith("3.")
    assert "post" in spec["paths"]["/jobs"]
    status, ui, _ = call(srv, "GET", "/swagger-ui")
    assert status == 200 and "/jobs" in ui
    evil = {"Origin": "https://evil.example"}
    r = call(srv, "GET", "/info", headers=evil)[2]
    assert "Access-Control-Allow-Origin" not in r.headers
    assert r.headers["Vary"] == "Origin"
    rig.api.config.cors_origins = ("https://dashboard.example",
                                   r"re:https://.*\.corp\.example")
    r = call(srv, "GET", "/info",
             headers={"Origin": "https://dashboard.example"})[2]
    assert r.headers["Access-Control-Allow-Origin"] == \
        "https://dashboard.example"
    assert r.headers["Access-Control-Allow-Credentials"] == "true"
    r = call(srv, "GET", "/info",
             headers={"Origin": "https://cook.corp.example"})[2]
    assert r.headers["Access-Control-Allow-Origin"] == \
        "https://cook.corp.example"
    r = call(srv, "GET", "/info",
             headers={"Origin": "https://dashboardxexample"})[2]
    assert "Access-Control-Allow-Origin" not in r.headers
    rig.api.config.cors_origins = ("re:(unclosed",)
    status, _, r = call(srv, "GET", "/info", headers=evil)
    assert status == 200 and "Access-Control-Allow-Origin" not in r.headers


@PKGS
def test_pool_move_and_incremental_config(P, rigs):
    rig = rigs(P)
    uuid = submit(rig, [{"command": "x"}])["jobs"][0]
    assert call(rig.srv, "POST", "/pool-move", user="bob", json={
        "job": uuid, "pool": "gpu-pool"})[0] == 403
    status, body, _ = call(rig.srv, "POST", "/pool-move", user="admin",
                           json={"jobs": [uuid], "pool": "gpu-pool"})
    assert status == 201 and body == {"moved": [uuid], "skipped": [],
                                      "pool": "gpu-pool"}
    assert rig.store.jobs[uuid].pool == "gpu-pool"
    assert call(rig.srv, "POST", "/pool-move", user="admin", json={
        "jobs": [uuid], "pool": "nope"})[0] == 400
    status, body, _ = call(rig.srv, "POST", "/incremental-config",
                           user="admin", json={"rebalancer": {
                               "max_preemption": 3}})
    assert status == 201 and body["rebalancer"] == {"max_preemption": 3}
    assert call(rig.srv, "GET", "/incremental-config")[1] == body


# --------------------------------------------- tests/test_auth_limits.py


def make_request(headers=None):
    """A minimal request stand-in: authenticators only read .headers."""
    return SimpleNamespace(headers=headers or {})


@PKGS
def test_authenticators(P):
    auth = P.auth.BasicAuthenticator(verify=lambda u, p: p == "sekrit")
    ok = base64.b64encode(b"alice:sekrit").decode()
    bad = base64.b64encode(b"alice:nope").decode()
    assert auth.authenticate(
        make_request({"Authorization": f"Basic {ok}"})) == "alice"
    assert auth.authenticate(
        make_request({"Authorization": f"Basic {bad}"})) is None
    assert auth.authenticate(make_request({})) is None
    assert "WWW-Authenticate" in auth.challenge()

    def gss_accept(token: bytes):
        return "alice/host@EXAMPLE.COM" if token == b"valid" else None

    spnego = P.auth.SpnegoAuthenticator(gss_accept=gss_accept)
    good = base64.b64encode(b"valid").decode()
    forged = base64.b64encode(b"forged").decode()
    assert spnego.authenticate(
        make_request({"Authorization": f"Negotiate {good}"})) == "alice"
    assert spnego.authenticate(
        make_request({"Authorization": f"Negotiate {forged}"})) is None
    assert spnego.authenticate(
        make_request({"Authorization": "Negotiate !!!notb64"})) is None
    assert spnego.challenge() == {"WWW-Authenticate": "Negotiate"}
    # closed by default: no acceptor, nobody authenticates
    assert P.auth.SpnegoAuthenticator().authenticate(
        make_request({"Authorization": f"Negotiate {good}"})) is None
    composite = P.auth.CompositeAuthenticator(
        [P.auth.SpnegoAuthenticator(), P.auth.BasicAuthenticator()])
    assert composite.challenge() == {
        "WWW-Authenticate": 'Negotiate, Basic realm="cook"'}
    assert composite.authenticate(make_request({})) is None
    conf = P.auth.authenticator_from_config
    assert isinstance(conf({"kind": "spnego"}), P.auth.SpnegoAuthenticator)
    assert isinstance(conf({"kind": "basic"}), P.auth.BasicAuthenticator)
    assert conf({"kind": "dev"}).authenticate(make_request({})) == \
        "anonymous"
    with pytest.raises(ValueError):
        conf({"kind": "ldap"})


@PKGS
def test_gssapi_acceptor_real_library_rejects_garbage(P):
    """The ctypes GSSAPI acceptor binds the real libgssapi_krb5 and
    cleanly rejects malformed/unauthenticated tokens (with no KDC or
    keytab, rejection IS the correct behavior — the point is the call
    reaches the real library and comes back as a clean None)."""
    gssapi = importlib.import_module(P.auth.__name__.rsplit(".", 1)[0]
                                     + ".gssapi")
    acceptor = gssapi.make_gssapi_acceptor()
    if acceptor is None:
        pytest.skip("libgssapi_krb5 not present in this image")
    assert acceptor(b"\x00garbage-token") is None
    assert acceptor(b"") is None
    # a structurally plausible but unauthenticated SPNEGO header
    assert acceptor(b"\x60\x28\x06\x06\x2b\x06\x01\x05\x05\x02") is None
    # end to end through the authenticator: garbage -> 401 path
    auth = P.auth.SpnegoAuthenticator(gss_accept=acceptor)
    token = base64.b64encode(b"not-a-ticket").decode()
    assert auth.authenticate(
        make_request({"Authorization": f"Negotiate {token}"})) is None


@PKGS
def test_gssapi_config_wireup(P):
    """{"kind": "spnego", "gssapi": true} builds the real acceptor (or
    stays closed when the library is missing)."""
    gssapi = importlib.import_module(P.auth.__name__.rsplit(".", 1)[0]
                                     + ".gssapi")
    auth = P.auth.authenticator_from_config({"kind": "spnego",
                                             "gssapi": True})
    assert isinstance(auth, P.auth.SpnegoAuthenticator)
    if gssapi._load_lib() is not None:
        assert auth.gss_accept is not None
    # unknown library path -> closed, not an exception
    closed = P.auth.authenticator_from_config(
        {"kind": "spnego", "gssapi": True, "gssapi_lib": "libnope.so.0"})
    assert closed.gss_accept is None


def _bare_rig(P, **api_kw):
    """A scheduler-less API on an empty store (test_auth_limits.py)."""
    store = P.store.JobStore(clock=FakeClock())
    store.set_pool(P.ent.Pool(name="default"))
    api = P.api.CookApi(store, config=P.api.ApiConfig(**api_kw))
    srv = P.server.ServerThread(api).start()
    return SimpleNamespace(store=store, api=api, srv=srv, url=srv.url)


@pytest.fixture
def bare():
    made = []

    def make(P, **api_kw):
        rig = _bare_rig(P, **api_kw)
        made.append(rig)
        return rig

    yield make
    for rig in made:
        rig.srv.stop()


@PKGS
def test_spnego_http_401_challenge_and_success(P, bare):
    def gss_accept(token: bytes):
        return "alice@EXAMPLE.COM" if token == b"tkt" else None

    rig = bare(P, authenticator=P.auth.SpnegoAuthenticator(
        gss_accept=gss_accept))
    status, _, r = call(rig.srv, "GET", "/pools", user=None)
    assert status == 401 and r.headers["WWW-Authenticate"] == "Negotiate"
    assert call(rig.srv, "GET", "/pools", user="mallory")[0] == 401
    token = base64.b64encode(b"tkt").decode()
    assert call(rig.srv, "GET", "/pools", user=None, headers={
        "Authorization": f"Negotiate {token}"})[0] == 200
    # an unknown route under strict auth: 401 before the 404, as aiohttp
    assert call(rig.srv, "GET", "/nope", user=None)[0] == 401


@PKGS
def test_spnego_gssapi_config_answers_garbage_with_a_challenge(P, bare):
    """The configured libgssapi_krb5 acceptor (or, without the library,
    the closed one) behind a live server: a garbage Negotiate token gets
    a 401 and the Negotiate challenge."""
    rig = bare(P, authenticator=P.auth.authenticator_from_config(
        {"kind": "spnego", "gssapi": True}))
    token = base64.b64encode(b"\x00garbage-token").decode()
    status, _, r = call(rig.srv, "GET", "/pools", user=None, headers={
        "Authorization": f"Negotiate {token}"})
    assert status == 401 and r.headers["WWW-Authenticate"] == "Negotiate"


@PKGS
def test_machine_endpoints_exempt_and_executor_token(P, bare):
    rig = bare(P, authenticator=P.auth.SpnegoAuthenticator())
    srv = rig.srv
    assert call(srv, "GET", "/debug", user=None)[0] == 200
    assert call(srv, "GET", "/debug/health", user=None)[0] == 200
    assert call(srv, "GET", "/metrics", user=None)[0] == 200
    assert call(srv, "POST", "/heartbeat/nope", user=None)[0] == 404
    assert call(srv, "POST", "/progress/nope", user=None, json={
        "progress_percent": 10, "sequence": 1})[0] == 404
    assert call(srv, "GET", "/pools", user=None)[0] == 401
    rig2 = bare(P, authenticator=P.auth.SpnegoAuthenticator(),
                executor_token="s3cret")
    srv = rig2.srv
    assert call(srv, "POST", "/heartbeat/nope", user=None)[0] == 401
    assert call(srv, "POST", "/heartbeat/nope", user=None, headers={
        "X-Cook-Executor-Token": "wrong"})[0] == 401
    assert call(srv, "POST", "/heartbeat/nope", user=None, headers={
        "X-Cook-Executor-Token": "s3cret"})[0] == 404
    assert call(srv, "GET", "/debug", user=None)[0] == 200


# the reference's ADMIN_GATED list, minus /shutdown-leader (not ported)
ADMIN_GATED = [
    ("POST", "/compute-clusters", {"name": "x", "kind": "mock"}),
    ("DELETE", "/compute-clusters/m", None),
    ("POST", "/incremental-config", {"x": 1}),
    ("POST", "/share", {"user": "bob", "share": {"mem": 1}}),
    ("DELETE", "/share?user=bob", None),
    ("POST", "/quota", {"user": "bob", "quota": {"mem": 1}}),
    ("DELETE", "/quota?user=bob", None),
    ("POST", "/pool-move", {"job": "x", "pool": "default"}),
]


@PKGS
def test_admin_gated_routes(P, bare):
    rig = bare(P)
    for method, path, body in ADMIN_GATED:
        assert call(rig.srv, method, path, user="mallory",
                    json=body)[0] == 403, f"{method} {path} as mallory"
    for method, path, body in ADMIN_GATED:
        assert call(rig.srv, method, path, user="admin",
                    json=body)[0] != 403, f"{method} {path} as admin"


@PKGS
def test_file_url_generator_seam(P):
    clock = FakeClock()
    store = P.store.JobStore(clock=clock)
    store.set_pool(P.ent.Pool(name="default"))
    cluster = P.mock.MockCluster(
        "m", [P.mock.MockHost(node_id="h", hostname="h", mem=1000,
                              cpus=4)],
        clock=clock, sandbox_url_fn=lambda tid: f"http://backend/{tid}")
    scheduler = P.core.Scheduler(store, [cluster], **P.kw)

    class Generator:
        def file_url(self, instance):
            return f"https://files.corp/{instance.task_id}"

    job = mk_job(P)
    store.submit_jobs([job])
    store.create_instance(job.uuid, "t1", hostname="h", node_id="h",
                          compute_cluster="m")
    plugins = P.plugins.PluginRegistry(file_url_generator=Generator())
    api = P.api.CookApi(store, scheduler, plugins=plugins)
    assert api._instance_json(store.instances["t1"])["output_url"] == \
        "https://files.corp/t1"
    assert P.api.CookApi(store, scheduler)._instance_json(
        store.instances["t1"])["output_url"] == "http://backend/t1"


@PKGS
def test_per_cluster_launch_rate_limiter(P):
    clock = FakeClock()
    store = P.store.JobStore(clock=clock)
    store.set_pool(P.ent.Pool(name="default"))
    cluster = P.mock.MockCluster(
        "m", [P.mock.MockHost(node_id="h", hostname="h", mem=64000,
                              cpus=64)], clock=clock)
    cluster.launch_rate_limiter = P.ratelimit.TokenBucketRateLimiter(
        tokens_replenished_per_minute=2.0, bucket_size=2.0, clock=clock)
    scheduler = P.core.Scheduler(store, [cluster], **P.kw)
    store.submit_jobs([mk_job(P, mem=100, cpus=1) for _ in range(5)])
    pool = store.pools["default"]
    scheduler.rank_cycle(pool)
    outcome = scheduler.match_cycle(pool)
    assert (len(outcome.matched), len(outcome.unmatched)) == (2, 3)
    scheduler.rank_cycle(pool)
    assert len(scheduler.match_cycle(pool).matched) == 0
    clock.advance(60_000)
    scheduler.rank_cycle(pool)
    assert len(scheduler.match_cycle(pool).matched) == 2


@PKGS
def test_factory_attaches_launch_limiter(P):
    cluster = P.components.CLUSTER_FACTORIES["mock"](
        {"name": "m", "hosts": [{"node_id": "h", "mem": 100, "cpus": 1}],
         "launch_rate_per_minute": 10, "launch_burst": 3}, FakeClock())
    assert cluster.launch_rate_limiter.tokens_available("m") == 3.0


@PKGS
def test_submission_rate_limit_429(P, bare):
    rig = bare(P, submission_rate_per_minute=2.0)
    body = {"jobs": [{"command": "x"}]}
    assert call(rig.srv, "POST", "/jobs", json=body)[0] == 201
    assert call(rig.srv, "POST", "/jobs", json=body)[0] == 201
    status, out, _ = call(rig.srv, "POST", "/jobs", json=body)
    assert status == 429 and "rate limit" in out["error"]


# ------------------------------------------ tests/test_health_endpoint.py


@pytest.fixture
def health_rigs(rigs):
    """A rig whose telemetry is fresh and deterministic off-device (no
    memory probe, no storm warmup), shadow-solving every cycle."""

    def make(P):
        config = P.core.SchedulerConfig()
        config.quality_sample_every = 1
        rig = rigs(P, pools=("default",), config=config)
        rig.telemetry = P.telemetry.DeviceTelemetry(
            memory_stats_fn=lambda: None, storm_warmup=0,
            quality_sample_every=1)
        rig.scheduler.telemetry = rig.telemetry
        return rig

    return make


def get_health(rig):
    status, body, _ = call(rig.srv, "GET", "/debug/health")
    assert status == 200
    return body


@PKGS
def test_healthy_by_default_with_every_check(P, health_rigs):
    rig = health_rigs(P)
    health = get_health(rig)
    assert health["healthy"] and health["status"] == "ok"
    assert health["degradations"] == []
    assert set(health["checks"]) == {"compile", "quality", "solve_latency",
                                     "device_fallback", "device_memory",
                                     "contention", "fairness"}
    assert set(health["checks"]["contention"]) == {
        "store_lock", "journal", "replication", "commit_ack", "starvation"}


@PKGS
def test_health_transitions(P, health_rigs):
    rig = health_rigs(P)
    t = rig.telemetry
    bucket = P.common.bucket_size
    for queue_len in [100, 1100, 2100, 4100, 8200, 100]:
        t.record_solve("match", (bucket(queue_len), 2048), "xla", 0.01)
    health = get_health(rig)
    assert health["reasons"] == ["recompile-storm"]
    assert "padded-shape churn" in health["degradations"][0]["detail"]
    for _ in range(40):
        t.record_solve("match", (128, 2048), "xla", 0.01)
    assert get_health(rig)["healthy"]
    for _ in range(12):
        t.quality.record_sample("default", 1.0)
    for _ in range(4):
        t.quality.record_sample("default", 0.90)
    health = get_health(rig)
    assert health["reasons"] == ["quality-drift"]
    assert health["degradations"][0]["efficiency"] == pytest.approx(0.90)
    for _ in range(8):
        t.quality.record_sample("default", 1.0)
    assert get_health(rig)["healthy"]
    t.record_match_solve("default", (1024, 128), "xla", 5.0)
    for _ in range(16):
        t.record_match_solve("default", (1024, 128), "xla", 0.010)
    assert get_health(rig)["healthy"]
    for _ in range(8):
        t.record_match_solve("default", (1024, 128), "xla", 0.120)
    health = get_health(rig)
    assert health["reasons"] == ["solve-latency-regression"]
    usage = {"fill": 0.97}
    t.health_monitor.memory_stats_fn = lambda: {
        "bytes_in_use": usage["fill"] * 100.0, "bytes_limit": 100.0,
        "peak_bytes_in_use": 95.0, "utilization": usage["fill"]}
    for _ in range(8):
        t.record_match_solve("default", (1024, 128), "xla", 0.010)
    assert "device-oom-risk" in get_health(rig)["reasons"]
    usage["fill"] = 0.4
    for _ in range(64):
        t.record_match_solve("default", (1024, 128), "xla", 0.010)
    assert get_health(rig)["healthy"]


def run_cycle(rig, n_jobs=2):
    uuids = []
    for _ in range(n_jobs):
        job = mk_job(rig.P, mem=64, cpus=0.5)
        rig.store.submit_jobs([job])
        uuids.append(job.uuid)
    cycle(rig)
    return uuids


@PKGS
def test_device_truth_on_the_wire(P, health_rigs):
    rig = health_rigs(P)
    run_cycle(rig)
    [record] = call(rig.srv, "GET", "/debug/cycles?limit=1")[1]["cycles"]
    assert record["solve_shape"] == "64x64"
    assert record["backend"] == "exact"
    assert isinstance(record["compiled"], bool)
    status, one, _ = call(rig.srv, "GET", f"/debug/cycles/{record['cycle']}")
    assert status == 200 and one["cycle"] == record["cycle"]
    assert call(rig.srv, "GET", "/debug/cycles/999999")[0] == 404
    assert call(rig.srv, "GET", "/debug/cycles/x")[0] == 400
    text = call(rig.srv, "GET", "/metrics")[1]
    m = re.search(r'cook_obs_compile_count\{backend="exact",op="match",'
                  r'shape="64x64"\} ([0-9.]+)', text)
    assert m is not None and float(m.group(1)) >= 1.0
    assert 'op="rank"' in text and "cook_obs_solve_seconds_bucket" in text
    job = mk_job(P, mem=999999, cpus=64)
    rig.store.submit_jobs([job])
    cycle(rig)
    [entry] = call(rig.srv, "GET", "/unscheduled_jobs",
                   params={"job": job.uuid})[1]
    assert entry["pool_solve"]["backend"] == "exact"
    assert entry["reasons"]
    stats = rig.telemetry.quality.stats()["default"]
    assert stats["samples"] >= 1 and stats["last"] == pytest.approx(1.0)
    assert get_health(rig)["checks"]["quality"]["default"]["last"] == \
        pytest.approx(1.0)


# --------------------------- the REST cases earlier slices left out


@PKGS
def test_debug_predictions(P, rigs):
    """tests/test_prediction.py's REST case: speculation off -> the
    surface says so; on -> predictor and speculator stats."""
    rig = rigs(P, pools=("default",))
    body = call(rig.srv, "GET", "/debug/predictions")[1]
    assert body == {"enabled": False, "predictor": None,
                    "speculation": None}
    rig2 = rigs(P, pools=("default",),
                config=P.core.SchedulerConfig(speculation=True))
    body = call(rig2.srv, "GET", "/debug/predictions")[1]
    assert body["enabled"] is True
    assert body["predictor"]["observations"] == 0
    assert body["speculation"]["dispatched"] == 0


@PKGS
def test_debug_elastic_and_metrics(P, rigs):
    """tests/test_elastic.py's REST cases: the ledger renders with the
    planner off, and the plane's metrics reach /metrics."""
    rig = rigs(P)
    status, body, _ = call(rig.srv, "GET", "/debug/elastic")
    assert status == 200
    assert body == {"enabled": False, "ledger": [],
                    "net": {"default": {"mem": 0.0, "cpus": 0.0,
                                        "gpus": 0.0},
                            "gpu-pool": {"mem": 0.0, "cpus": 0.0,
                                         "gpus": 0.0}},
                    "plans": []}
    assert call(rig.srv, "GET", "/debug/elastic?limit=x")[0] == 400
    rig2 = rigs(P, config=P.core.SchedulerConfig(
        elastic=P.elastic.ElasticParams(enabled=True)))
    for pool in ("default", "gpu-pool"):
        rig2.scheduler.rank_cycle(rig2.store.pools[pool])
    rig2.scheduler.elastic_cycle()
    body = call(rig2.srv, "GET", "/debug/elastic")[1]
    assert body["enabled"] is True and len(body["plans"]) == 1
    assert call(rig2.srv, "GET", "/debug/elastic?kind=reclaim")[1][
        "plans"] == []
    text = call(rig2.srv, "GET", "/metrics")[1]
    assert "cook_elastic_plans" in text


@PKGS
def test_debug_faults_gate_arm_disarm(P, bare):
    rig = bare(P)
    assert call(rig.srv, "GET", "/debug/faults")[0] == 403
    assert call(rig.srv, "POST", "/debug/faults", user="admin",
                json={"disarm": True})[0] == 403
    rig = bare(P, fault_injection=True)
    assert call(rig.srv, "GET", "/debug/faults")[1] == {
        "enabled": True, "armed": False, "schedule": None}
    rules = {"seed": 3, "rules": [{"point": "journal.fsync",
                                   "mode": "error", "times": 1}]}
    assert call(rig.srv, "POST", "/debug/faults", user="bob",
                json=rules)[0] == 403
    status, body, _ = call(rig.srv, "POST", "/debug/faults", user="admin",
                           json=rules)
    assert status == 200 and body["armed"] is True
    assert P.faults.ACTIVE is not None
    got = call(rig.srv, "GET", "/debug/faults")[1]
    assert got["armed"] and got["schedule"]["rules"][0]["point"] == \
        "journal.fsync"
    assert call(rig.srv, "POST", "/debug/faults", user="admin", json={
        "rules": [{"point": "nope", "mode": "error"}]})[0] == 400
    assert call(rig.srv, "POST", "/debug/faults", user="admin",
                json={"disarm": True})[1] == {"armed": False}
    assert P.faults.ACTIVE is None


@PKGS
def test_debug_incidents_history_and_contention(P, rigs):
    rig = rigs(P, pools=("default",))
    srv = rig.srv
    body = call(srv, "GET", "/debug/incidents")[1]
    assert body["incidents"] == [] and body["capacity"] == 32
    assert call(srv, "GET", "/debug/incidents/nope")[0] == 404
    # a degraded verdict captures one bundle with the REST layer's
    # evidence (contention, history) beside the scheduler's
    t = rig.scheduler.telemetry
    t.health_monitor.memory_stats_fn = lambda: {
        "bytes_in_use": 97.0, "bytes_limit": 100.0,
        "peak_bytes_in_use": 97.0, "utilization": 0.97}
    assert "device-oom-risk" in get_health(rig)["reasons"]
    [summary] = call(srv, "GET", "/debug/incidents")[1]["incidents"]
    assert summary["reasons"] == ["device-oom-risk"]
    status, bundle, _ = call(srv, "GET", f"/debug/incidents/{summary['id']}")
    assert status == 200
    assert {"verdict", "contention", "history", "cycles",
            "fairness"} <= set(bundle)
    hist = call(srv, "GET", "/debug/history")[1]
    assert hist["enabled"] is True and "series" in hist
    rig.api.history.sample_once()
    hist = call(srv, "GET", "/debug/history",
                params={"metric": "cook_jobs_submitted"})[1]
    assert hist["step"] == "raw"
    assert call(srv, "GET", "/debug/history",
                params={"since": "x"})[0] == 400
    assert call(srv, "GET", "/debug/history", params={
        "metric": "x", "step": "9h"})[0] == 400
    cont = call(srv, "GET", "/debug/contention")[1]
    assert {"store_lock", "journal", "replication", "endpoints",
            "commit_ack"} <= set(cont)
    # the profiled store lock reports its call sites (wired as in the
    # reference)
    assert cont["store_lock"]["acquisitions"] > 0


@PKGS
def test_debug_profile_status_gate_and_capture(P, rigs, tmp_path):
    rig = rigs(P, pools=("default",), config=P.core.SchedulerConfig(
        profile_dir=str(tmp_path)))
    srv = rig.srv
    body = call(srv, "GET", "/debug/profile")[1]
    assert body["enabled"] is True and body["active"] is None
    assert call(srv, "POST", "/debug/profile", user="bob",
                json={"duration_s": 0.2})[0] == 403
    assert call(srv, "POST", "/debug/profile", user="admin",
                json={"duration_s": "x"})[0] == 400
    assert call(srv, "POST", "/debug/profile", user="admin",
                json={"duration_s": -1})[0] == 400
    status, body, _ = call(srv, "POST", "/debug/profile", user="admin",
                           json={"duration_s": 0.5})
    assert status == 202 and body["started"] is True
    status, again, _ = call(srv, "POST", "/debug/profile", user="admin",
                            json={"duration_s": 0.5})
    assert status == 409 and again["reason"] == "capture-in-flight"
    deadline = time.monotonic() + 20
    while call(srv, "GET", "/debug/profile")[1]["active"] is not None:
        assert time.monotonic() < deadline
        time.sleep(0.1)
    assert len(call(srv, "GET", "/debug/profile")[1]["recent"]) == 1


@PKGS
def test_timeline_spans_trace_and_fairness(P, rigs):
    rig = rigs(P, pools=("default",))
    uuid = submit(rig, [{"command": "t", "mem": 100, "cpus": 1}])["jobs"][0]
    cycle(rig)
    status, tl, _ = call(rig.srv, "GET", f"/jobs/{uuid}/timeline")
    assert status == 200 and tl["uuid"] == uuid
    kinds = [e["kind"] for e in tl["events"]]
    assert kinds[0] == "submitted" and "launched" in kinds
    assert call(rig.srv, "GET", "/jobs/nope/timeline")[0] == 404
    txn = {"X-Cook-Txn-Id": "txn-rest-1"}
    assert call(rig.srv, "POST", "/jobs", headers=txn, json={
        "jobs": [{"command": "u"}]})[0] == 201
    spans = call(rig.srv, "GET", "/debug/spans",
                 params={"txn_id": "txn-rest-1"})[1]["spans"]
    assert any(s["name"] == "rest.commit" for s in spans)
    raw = call(rig.srv, "GET", "/debug/trace", params={
        "format": "raw", "txn_id": "txn-rest-1"})[1]
    assert raw["txn_id"] == "txn-rest-1" and raw["process"] is None
    chrome = call(rig.srv, "GET", "/debug/trace")[1]
    assert "traceEvents" in chrome
    assert call(rig.srv, "GET", "/debug/trace?format=x")[0] == 400
    fair = call(rig.srv, "GET", "/debug/fairness")[1]
    assert "default" in fair["pools"]
    assert call(rig.srv, "GET", "/debug/fairness?ledger=x")[0] == 400


@PKGS
def test_shedder_429_on_heavy_reads_only(P, rigs):
    """faults/reactions.LoadShedder behind the REST layer: while the
    commit-ack SLO burns, heavy reads answer 429 + Retry-After; writes
    and cheap probes pass."""
    rig = rigs(P, pools=("default",))
    uuid = submit(rig, [{"command": "s"}])["jobs"][0]
    rig.api.shedder.should_shed = lambda route: {
        "reason": "commit-ack-slo-burn", "detail": f"shedding {route}",
        "retry_after_s": 2.5}
    for path in ("/jobs?user=alice", "/queue", "/running",
                 "/list?user=alice", f"/unscheduled_jobs?job={uuid}",
                 "/stats/instances"):
        status, body, r = call(rig.srv, "GET", path)
        assert status == 429, path
        assert r.headers["Retry-After"] == "2"
        assert body["error"].startswith("shedding /")
    assert call(rig.srv, "GET", f"/jobs/{uuid}")[0] == 200
    assert call(rig.srv, "GET", "/debug")[0] == 200
    assert call(rig.srv, "POST", "/jobs", json={
        "jobs": [{"command": "w"}]})[0] == 201
    rig.api.config.load_shedding = False
    assert call(rig.srv, "GET", "/queue")[0] == 200


# ------------------------------------------- transcripts, ref vs port

UUID_RE = re.compile(
    r"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{12}")
# fields whose values are wall-clock readings or depend on them
WALL_KEYS = {"wall_time", "duration_s", "phases", "device_s", "ts",
             "seconds",
             "trace_id", "span_id", "recent", "t_ms_wall", "age_s"}


def normalise(value, names):
    """Generated uuids -> <uuid-N> in order of first appearance (task ids
    carry their job's first 8 hex digits too); wall-time fields -> "*"."""
    if isinstance(value, dict):
        return {k: ("*" if k in WALL_KEYS else normalise(v, names))
                for k, v in value.items()}
    if isinstance(value, list):
        return [normalise(v, names) for v in value]
    if isinstance(value, str):
        def sub(m):
            return names.setdefault(m.group(0), f"<uuid-{len(names)}>")
        value = UUID_RE.sub(sub, value)
        for full, name in list(names.items()):
            value = value.replace(f"task-{full[:8]}-", f"task-{name}-")
        return value
    return value


def transcript(rig, steps):
    """Run `steps` (method, path, user, kwargs) or callables against the
    rig; each request's (label, status, normalised body)."""
    names: dict = {}
    out = []
    for step in steps:
        if callable(step):
            step(rig)
            continue
        method, path, user, kw = step
        status, body, _ = call(rig.srv, method, path, user=user, **kw)
        out.append((f"{method} {path}", status, normalise(body, names)))
    return out


J1 = "aaaaaaaa-0000-0000-0000-000000000001"
J2 = "aaaaaaaa-0000-0000-0000-000000000002"
J3 = "aaaaaaaa-0000-0000-0000-000000000003"
G1 = "bbbbbbbb-0000-0000-0000-000000000001"

JOBS_SCRIPT = [
    ("POST", "/jobs", "alice", {"json": {"jobs": [
        {"uuid": J1, "command": "a", "mem": 512, "cpus": 1,
         "labels": {"x": "1"}, "env": {"E": "v"}, "max_retries": 3},
        {"uuid": J2, "command": "b", "mem": 1024, "cpus": 2,
         "group": G1, "priority": 70}],
        "groups": [{"uuid": G1, "host_placement": {"type": "unique"},
                    "straggler_handling": {"type": "quantile-deviation",
                                           "parameters": {
                                               "quantile": 0.5}}}]}}),
    ("POST", "/jobs", "bob", {"json": {"jobs": [
        {"uuid": J3, "command": "b1", "mem": 256}]}}),
    ("POST", "/jobs", "alice", {"json": {"jobs": [{"uuid": J1,
                                                   "command": "dup"}]}}),
    ("POST", "/jobs", "alice", {"json": {"jobs": [{"command": "x",
                                                   "ports": 9999}]}}),
    ("POST", "/jobs", "alice", {"json": {"jobs": [{"command": "x",
                                                   "mem": "lots"}]}}),
    ("POST", "/jobs", "alice", {"json": {"jobs": [
        {"command": "g", "gang_size": 2, "group": "gg"}]}}),
    ("POST", "/jobs", "alice", {"data": "{bad"}),
    ("GET", f"/jobs/{J1}", "alice", {}),
    ("GET", "/jobs", "alice", {"params": {"user": "alice"}}),
    ("GET", "/jobs", "alice", {"params": {"user": "alice",
                                          "state": "waiting"}}),
    ("GET", "/jobs", "alice", {}),
    ("GET", "/jobs", "alice", {"params": {"job": "nope"}}),
    ("GET", "/rawscheduler", "alice", {"params": {"job": J2}}),
    ("GET", "/group", "alice", {"params": [("uuid", G1),
                                           ("detailed", "1")]}),
    ("GET", "/queue", "alice", {}),
    lambda rig: rig.scheduler.rank_cycle(rig.store.pools["default"]),
    ("GET", "/queue", "alice", {}),
    ("GET", f"/unscheduled_jobs?job={J1}", "alice", {}),
    lambda rig: cycle(rig),
    ("GET", f"/jobs/{J1}", "alice", {}),
    ("GET", "/running", "alice", {}),
    ("GET", "/usage", "alice", {"params": {"user": "alice"}}),
    ("GET", "/usage", "alice", {}),
    ("GET", "/list", "alice", {"params": {"user": "alice",
                                          "state": "running,waiting"}}),
    ("GET", f"/unscheduled_jobs?job={J1}", "alice", {}),
    ("GET", "/instances", "alice", {"params": {"instance": "nope"}}),
    ("POST", "/retry", "alice", {"json": {"jobs": [J1], "retries": 4}}),
    ("POST", "/retry", "alice", {"json": {"jobs": [J1]}}),
    ("GET", "/retry", "alice", {"params": {"job": J1}}),
    ("POST", "/share", "admin", {"json": {"user": "alice", "share": {
        "mem": 2048, "cpus": 4}}}),
    ("GET", "/share", "alice", {"params": {"user": "alice"}}),
    ("GET", "/share", "alice", {}),
    ("DELETE", "/share", "admin", {"params": {"user": "alice"}}),
    ("POST", "/quota", "admin", {"json": {"user": "bob", "quota": {
        "count": 1}}}),
    ("GET", "/quota", "alice", {"params": {"user": "bob"}}),
    ("POST", "/jobs", "bob", {"json": {"jobs": [{"command": "over"}]}}),
    ("DELETE", "/jobs", "bob", {"params": {"job": J1}}),
    ("DELETE", "/jobs", "alice", {"params": {"job": J1}}),
    ("GET", f"/jobs/{J1}", "alice", {}),
    ("DELETE", "/jobs", "alice", {}),
    ("GET", "/pools", "alice", {}),
    ("GET", "/settings", "alice", {}),
    ("GET", "/info", "alice", {}),
    ("GET", "/failure_reasons", "alice", {}),
    ("GET", "/compute-clusters", "alice", {}),
    ("GET", "/incremental-config", "alice", {}),
    ("GET", "/stats/instances", "alice", {}),
    ("GET", "/debug", "alice", {}),
    ("GET", "/debug/elastic", "alice", {}),
    ("GET", "/debug/predictions", "alice", {}),
    ("GET", "/debug/faults", "alice", {}),
    ("GET", "/debug/incidents", "alice", {}),
    ("POST", "/debug/profile", "bob", {"json": {"duration_s": 1}}),
    ("GET", "/nope", "alice", {}),
    ("PUT", "/jobs", "alice", {"json": {}}),
]


def _run_both(steps, **rig_kw):
    out = {}
    for P in (REF, PORT):
        rig = make_rig(P, **rig_kw)
        try:
            out[P.name] = transcript(rig, steps)
        finally:
            rig.srv.stop()
    return out


def test_job_routes_transcript_equals_the_reference():
    """The jobs, groups, queue, retry, share, quota, kill, usage, list,
    settings and debug routes: one script, both servers, every status
    and normalised body equal."""
    out = _run_both(JOBS_SCRIPT)
    assert len(out["port"]) == len(out["ref"])
    for ref_step, port_step in zip(out["ref"], out["port"]):
        assert port_step == ref_step, ref_step[0]


def _instance_steps(t1, t2):
    return [
        ("GET", f"/instances/{t1}", "alice", {}),
        ("POST", f"/progress/{t1}", "alice", {"json": {
            "progress_percent": 30, "progress_message": "m"}}),
        ("GET", f"/progress/{t1}", "alice", {}),
        ("POST", f"/heartbeat/{t1}", "alice", {}),
        ("DELETE", "/instances", "bob", {"params": {"instance": t1}}),
        ("DELETE", "/instances", "alice", {"params": {"instance": t1}}),
        ("GET", f"/jobs/{J1}", "alice", {}),
        ("GET", "/instances", "alice", {"params": {"instance": t2}}),
    ]


def test_instance_routes_transcript_equals_the_reference():
    """Instances, progress, heartbeats, cancellation, completion and the
    timeline after a real match cycle on both packages."""
    out = {}
    for P in (REF, PORT):
        rig = make_rig(P)
        try:
            submit(rig, [{"uuid": J1, "command": "a", "mem": 512, "cpus": 1,
                          "max_retries": 2},
                         {"uuid": J2, "command": "b", "mem": 512,
                          "cpus": 1}])
            cycle(rig)
            t1 = rig.store.job_instances(J1)[0].task_id
            t2 = rig.store.job_instances(J2)[0].task_id
            out[P.name] = transcript(rig, _instance_steps(t1, t2))
            rig.clock.advance(120_000)
            rig.cluster.advance_to(rig.clock.now_ms)
            out[P.name] += transcript(rig, [
                ("GET", f"/jobs/{J2}", "alice", {}),
                ("GET", "/stats/instances", "alice", {}),
                ("GET", f"/jobs/{J1}/timeline", "alice", {})])
        finally:
            rig.srv.stop()
    assert len(out["port"]) == len(out["ref"])
    for ref_step, port_step in zip(out["ref"], out["port"]):
        assert port_step == ref_step, ref_step[0]


def test_swagger_paths_are_the_reference_routes_minus_the_waiting_ones():
    # nothing waits since the fleet observatory's port: every reference
    # route serves
    waiting = set()
    specs = {}
    for P in (REF, PORT):
        rig = make_rig(P)
        try:
            specs[P.name] = call(rig.srv, "GET", "/swagger-docs")[1]
            # no fleet observatory on a bare node: both say so alike
            status, body = call(rig.srv, "GET", "/debug/fleet",
                                user="admin")[:2]
            assert status == 200 and body["enabled"] is False
            # the control plane's routes serve on both packages
            for path in ("/replication/journal", "/replication/snapshot",
                         "/debug/replica"):
                assert call(rig.srv, "GET", path, user="admin")[0] == 200
            assert call(rig.srv, "POST", "/replication/ack", user="admin",
                        json={"follower": "f", "seq": 1})[0] == 200
        finally:
            rig.srv.stop()
    def routes(spec):
        # (path, method, handler) — the summaries are docstrings, which
        # name each package's own modules
        return {(path, method, info["operationId"])
                for path, methods in spec["paths"].items()
                for method, info in methods.items()}

    assert routes(specs["port"]) == {r for r in routes(specs["ref"])
                                     if r[0] not in waiting}


# ----------------------------------------------- the shim's concurrency


def test_keep_alive_requests_are_not_held_back():
    """Requests on one keep-alive connection answer back to back: the
    server sets TCP_NODELAY (as aiohttp does), so a response's body is not
    held until the client's delayed ACK (~40 ms a request otherwise)."""
    from http.client import HTTPConnection

    cp = port_server.InprocessControlPlane().start()
    conn = HTTPConnection("127.0.0.1", cp.server.port, timeout=10)
    try:
        t0 = time.monotonic()
        for _ in range(25):
            conn.request("GET", "/debug")
            resp = conn.getresponse()
            assert resp.status == 200 and resp.read()
        assert time.monotonic() - t0 < 0.5
    finally:
        conn.close()
        cp.stop()


def test_commit_releases_the_loop_lock_for_other_requests():
    """While one request's commit is in the pipeline (the reference
    awaits it in an executor), other requests are served; handler bodies
    themselves never overlap."""
    rig = make_rig(PORT, pools=("default",))
    try:
        entered = threading.Event()
        release = threading.Event()
        commit = rig.api.txn.commit

        def slow_commit(op, payload, txn_id=None):
            if op == "jobs/submit" and not entered.is_set():
                entered.set()
                assert release.wait(TIMEOUT_S)
            return commit(op, payload, txn_id=txn_id)

        rig.api.txn.commit = slow_commit
        result = {}
        t = threading.Thread(target=lambda: result.update(
            first=call(rig.srv, "POST", "/jobs",
                       json={"jobs": [{"command": "a"}]})[0]))
        t.start()
        assert entered.wait(TIMEOUT_S)
        # the loop is free while the first commit waits on its "fsync"
        assert call(rig.srv, "GET", "/debug")[0] == 200
        assert call(rig.srv, "POST", "/jobs", json={
            "jobs": [{"command": "b"}]})[0] == 201
        release.set()
        t.join(TIMEOUT_S)
        assert result["first"] == 201 and len(rig.store.jobs) == 2
    finally:
        rig.srv.stop()


def test_handlers_run_one_at_a_time():
    rig = make_rig(PORT, pools=("default",))
    try:
        active = []
        peak = []
        get_pools = rig.api.get_pools

        def counted(request):
            active.append(1)
            peak.append(len(active))
            time.sleep(0.02)
            active.pop()
            return get_pools(request)

        app_handle = rig.srv._server.RequestHandlerClass.app
        for route in app_handle.router._routes:
            if route.template == "/pools":
                object.__setattr__(route, "handler", counted)
        threads = [threading.Thread(target=call,
                                    args=(rig.srv, "GET", "/pools"))
                   for _ in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(TIMEOUT_S)
        assert len(peak) == 8 and max(peak) == 1
    finally:
        rig.srv.stop()


def test_a_failing_handler_is_a_500_not_a_fallback():
    rig = make_rig(PORT, pools=("default",))
    try:
        def boom(_request):
            raise RuntimeError("solve failed on the card")

        app = rig.srv._server.RequestHandlerClass.app
        for route in app.router._routes:
            if route.template == "/queue":
                object.__setattr__(route, "handler", boom)
        status, body, _ = call(rig.srv, "GET", "/queue")
        assert status == 500 and "Internal Server Error" in body
        assert call(rig.srv, "GET", "/debug")[0] == 200
    finally:
        rig.srv.stop()


def test_standby_proxies_queue_to_leader():
    store = PORT.store.JobStore(clock=lambda: 0)
    store.set_pool(PORT.ent.Pool(name="default"))
    api = PORT.api.CookApi(store, None, PORT.api.ApiConfig())
    api.leader = False
    api.leader_url = "http://leader.example:12321"
    srv = PORT.server.ServerThread(api).start()
    try:
        status, _, r = call(srv, "GET", "/queue", user="u")
        assert status == 307
        assert r.headers["Location"] == "http://leader.example:12321/queue"
    finally:
        srv.stop()


def test_json_bodies_are_json_typed():
    rig = make_rig(PORT, pools=("default",))
    try:
        r = call(rig.srv, "GET", "/pools")[2]
        assert r.headers["Content-Type"] == \
            "application/json; charset=utf-8"
        assert json.loads(r.text) == [{"name": "default", "purpose": "",
                                       "state": "active",
                                       "dru-mode": "default"}]
    finally:
        rig.srv.stop()


def test_concurrent_submits_lose_no_update():
    """More client threads than cores submitting at once, with a short
    thread switch interval: every connection is accepted (the listen
    backlog is aiohttp's 128, not the standard library's 5, which reset
    connections here), every job lands in the store once, and the
    submission limiter's bucket and the endpoint telemetry count every
    request exactly once."""
    import sys

    rig = make_rig(PORT, pools=("default",), api_config=PORT.api.ApiConfig(
        submission_rate_per_minute=10_000.0))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        n_threads, per_thread = 24, 5
        errors = []

        def client(k):
            for i in range(per_thread):
                try:
                    status, _, _ = call(rig.srv, "POST", "/jobs",
                                        user="alice", json={"jobs": [
                                            {"command": f"{k}-{i}"},
                                            {"command": "x"}]})
                except requests.RequestException as e:
                    status = repr(e)
                if status != 201:
                    errors.append(status)

        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT_S * 4)
        assert not any(t.is_alive() for t in threads)
        assert errors == []
        n = n_threads * per_thread
        assert len(rig.store.jobs) == 2 * n
        bucket = rig.api.submission_limiter._buckets["alice"]
        assert bucket.tokens == pytest.approx(10_000.0 - 2 * n, abs=1.0)
        routes = rig.api.endpoints.snapshot()
        assert routes["POST /jobs"]["count"] == n
    finally:
        sys.setswitchinterval(interval)
        rig.srv.stop()


def test_inprocess_control_plane_journals_every_ack(tmp_path):
    """`rest/server.InprocessControlPlane`: store + journal with real
    fsyncs + commit pipeline + API, no scheduler.  Every acknowledged
    submit and kill is in its journal, and a store recovered from it
    holds them."""
    from cook_tpu_torch.models import persistence

    data = str(tmp_path)
    cp = PORT.server.InprocessControlPlane(data_dir=data).start()
    try:
        acked = []
        for i in range(5):
            status, body, _ = call(cp.server, "POST", "/jobs", json={
                "jobs": [{"command": f"c{i}"}, {"command": f"d{i}"}]})
            assert status == 201
            acked += body["jobs"]
        assert call(cp.server, "DELETE", "/jobs",
                    params={"job": acked[0]})[0] == 204
        assert call(cp.server, "GET", "/debug")[1] == {
            "healthy": True, "leader": False}
        cont = call(cp.server, "GET", "/debug/contention")[1]
        assert cont["journal"]["appends"] > 0
    finally:
        cp.stop()
    store = persistence.recover(data)
    assert sorted(store.jobs) == sorted(acked)
    assert store.jobs[acked[0]].state.value == "completed"
