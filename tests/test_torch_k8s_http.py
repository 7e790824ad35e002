"""The apiserver client of `cook_tpu_torch` (`cluster/k8s_http.py`)
against `cook_tpu` on the CPU, each over a live fake apiserver
(tests/fake_apiserver.py) speaking real HTTP on 127.0.0.1.

- The 11 cases of tests/test_k8s_http.py (quantity parsing, node and pod
  manifests, the watch driving the controller, the re-list after a 410
  gap, external deletion, bearer-token refresh, offers over HTTP, the
  whole service placing a pod) on both packages (`P` over `ref` /
  `port`), `test_full_process_schedules_onto_http_apiserver` on each
  package's `build_process`.
- The 3 cases of tests/test_faults.py::TestK8sRetrySplit on both.
- Across the packages: the quantity parsers, and the pod manifests the
  launches of one set of `TaskSpec`s POST (ports, env, checkpoint
  volumes, the file-server sidecar; a synthetic pod), are equal; each
  package's cluster adopts the other's live pods on startup.
- The port's own wiring: a node without leadership never acts on the
  leader's pods, where the reference's deletes them (ROADMAP Queue C,
  reference item 19); a restarted leader adopts its store's running pod;
  a cluster created over REST on the leader watches at once; `stop` ends
  a parked watch at once (reference item 21).
- `chip_smoke.py`'s phase 30 at a CPU test's size.
"""
import dataclasses
import os
import threading
import time
from types import SimpleNamespace

import pytest
import torch

from cook_tpu import components as ref_components
from cook_tpu import faults as ref_faults
from cook_tpu.cluster import base as ref_base
from cook_tpu.cluster import k8s as ref_k8s
from cook_tpu.cluster import k8s_http as ref_http
from cook_tpu.models import entities as ref_ent
from cook_tpu.utils import config as ref_config
from cook_tpu_torch import components as port_components
from cook_tpu_torch import faults as port_faults
from cook_tpu_torch.cluster import base as port_base
from cook_tpu_torch.cluster import k8s as port_k8s
from cook_tpu_torch.cluster import k8s_http as port_http
from cook_tpu_torch.models import entities as port_ent
from cook_tpu_torch.utils import config as port_config
from tests.fake_apiserver import make_server

# one intra-op thread: the suite runs several pytest-xdist workers side
# by side, and idle OpenMP threads spinning in each would crowd them
torch.set_num_threads(1)

REF = SimpleNamespace(name="ref", k8s=ref_k8s, http=ref_http, base=ref_base,
                      ent=ref_ent, faults=ref_faults,
                      components=ref_components, config=ref_config,
                      platform={})
PORT = SimpleNamespace(name="port", k8s=port_k8s, http=port_http,
                       base=port_base, ent=port_ent, faults=port_faults,
                       components=port_components, config=port_config,
                       platform={"platform": "cpu"})
PKGS = pytest.mark.parametrize("P", [REF, PORT], ids=["ref", "port"])


def wait_for(predicate, timeout=5.0, what="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


@pytest.fixture()
def apiserver():
    server, state, url = make_server()
    yield state, url
    server.shutdown()


@pytest.fixture()
def apis():
    made = []

    def make(P, url, **kw):
        api = P.http.HttpKubeApi(url, **{"namespace": "default",
                                         "watch_timeout_s": 5.0,
                                         "relist_backoff_s": 0.05, **kw})
        made.append(api)
        return api

    yield make
    for api in made:
        api.stop()


def spec(P, task_id="t1", node="n1", mem=512.0, cpus=2.0, **kw):
    return P.base.TaskSpec(**{
        "task_id": task_id, "job_uuid": "j1", "user": "alice",
        "command": "echo hi", "mem": mem, "cpus": cpus, "gpus": 0.0,
        "node_id": node, "hostname": node, "env": (("FOO", "bar"),),
        "container_image": "img:1", **kw})


def statuses_of(cluster, with_reason=True):
    out = []
    cluster.status_callback = lambda tid, st, reason: out.append(
        (tid, st.value, reason) if with_reason else (tid, st.value))
    return out


# --------------------------------------------- tests/test_k8s_http.py


@PKGS
def test_quantity_parsing(P):
    parse_mem, parse_cpu = P.http.parse_mem, P.http.parse_cpu
    assert parse_mem("512Mi") == 512.0
    assert parse_mem("2Gi") == 2048.0
    # unsuffixed memory is BYTES (the apiserver's normalized form)
    assert parse_mem("1073741824") == 1024.0
    assert parse_mem("1G") == pytest.approx(1e9 / (1024 * 1024))
    assert parse_mem("1Pi") == 1024.0**3
    assert parse_cpu("500m") == 0.5
    assert parse_cpu("4") == 4.0


@PKGS
def test_list_nodes_and_manifest_roundtrip(P, apiserver, apis):
    state, url = apiserver
    api = apis(P, url)
    state.add_node("n1", 8192, 16, labels={"cook.scheduler/pool": "default",
                                           "rack": "r1"})
    [node] = api.list_nodes()
    assert node.name == "n1" and node.mem == 8192 and node.cpus == 16
    assert node.schedulable and dict(node.labels)["rack"] == "r1"


@PKGS
def test_launch_builds_full_pod_manifest(P, apiserver, apis):
    state, url = apiserver
    state.add_node("n1", 8192, 16)
    cluster = P.k8s.KubeCluster("k", apis(P, url), lambda: 0)
    cluster.launch_tasks("default", [spec(P)])
    manifest = state.pods["t1"]
    assert manifest["spec"]["nodeName"] == "n1"
    [main] = [c for c in manifest["spec"]["containers"]
              if c["name"] == "cook-job"]
    assert main["image"] == "img:1"
    assert main["command"] == ["/bin/sh", "-c", "echo hi"]
    assert {"name": "FOO", "value": "bar"} in main["env"]
    assert main["resources"]["requests"]["memory"] == "512Mi"
    assert main["resources"]["requests"]["cpu"] == "2.0"
    assert manifest["metadata"]["labels"][P.http.COOK_MANAGED_LABEL] == \
        "true"


@PKGS
def test_checkpoint_pod_wiring(P, apiserver, apis):
    """A checkpointing job's pod gets the tools volume, init container,
    and the mount (api.clj:934,1173-1198); checkpoint env and the memory
    overhead arrive already folded into the TaskSpec by the matcher."""
    state, url = apiserver
    state.add_node("n1", 8192, 16)
    api = apis(P, url, checkpoint_tools_image="ckpt-tools:1")
    cluster = P.k8s.KubeCluster("k", api, lambda: 0)
    task = dataclasses.replace(spec(P), checkpoint_mode="auto",
                               checkpoint_periodic_sec=300)
    cluster.launch_tasks("default", [task])
    manifest = state.pods["t1"]
    [init] = manifest["spec"]["initContainers"]
    assert init["name"] == "aux-cook-init-container-for-checkpoint"
    assert init["image"] == "ckpt-tools:1"
    [volume] = manifest["spec"]["volumes"]
    assert volume["name"] == "cook-checkpoint-tools"
    [main] = [c for c in manifest["spec"]["containers"]
              if c["name"] == "cook-job"]
    assert main["volumeMounts"][0]["mountPath"] == "/opt/cook-checkpoint"
    # the spec's mem is used verbatim (overhead was added at match time)
    assert main["resources"]["requests"]["memory"] == "512Mi"


@PKGS
def test_watch_drives_controller_to_success(P, apiserver, apis):
    state, url = apiserver
    state.add_node("n1", 8192, 16)
    api = apis(P, url)
    cluster = P.k8s.KubeCluster("k", api, lambda: 0)
    statuses = statuses_of(cluster)
    api.start()
    cluster.launch_tasks("default", [spec(P)])
    wait_for(lambda: "t1" in state.pods, what="pod created")
    state.set_phase("t1", "Running")
    wait_for(lambda: ("t1", "running", None) in statuses,
             what="running status")
    state.set_phase("t1", "Succeeded")
    wait_for(lambda: ("t1", "success", "normal-exit") in statuses,
             what="success status")
    # the controller garbage-collects the completed pod via the api
    wait_for(lambda: "t1" not in state.pods, what="pod deleted")


@PKGS
def test_watch_gap_recovers_via_relist(P, apiserver, apis):
    """Events missed during a watch gap are reconstructed from a fresh
    LIST diff (the api.clj:449 re-list branch): a pod that completed
    while the watch was down still reaches the controller."""
    state, url = apiserver
    state.add_node("n1", 8192, 16)
    api = apis(P, url)
    cluster = P.k8s.KubeCluster("k", api, lambda: 0)
    statuses = statuses_of(cluster, with_reason=False)
    api.start()
    cluster.launch_tasks("default", [spec(P)])
    state.set_phase("t1", "Running")
    wait_for(lambda: ("t1", "running") in statuses, what="running")
    # compact history + sever the stream, then mutate during the outage
    state.inject_gap()
    state.set_phase("t1", "Succeeded")
    wait_for(lambda: ("t1", "success") in statuses, timeout=10,
             what="success via re-list after 410")


@PKGS
def test_pod_deleted_externally_is_mea_culpa(P, apiserver, apis):
    state, url = apiserver
    state.add_node("n1", 8192, 16)
    api = apis(P, url)
    cluster = P.k8s.KubeCluster("k", api, lambda: 0)
    statuses = statuses_of(cluster)
    api.start()
    cluster.launch_tasks("default", [spec(P)])
    state.set_phase("t1", "Running")
    wait_for(lambda: ("t1", "running", None) in statuses, what="running")
    state.delete_pod("t1")  # node drained / manual kubectl delete
    wait_for(
        lambda: ("t1", "failed", "could-not-reconstruct-state") in statuses,
        what="mea-culpa failure")


@PKGS
def test_bearer_token_refresh(P, apiserver, apis, tmp_path):
    state, url = apiserver
    token_file = tmp_path / "token"
    token_file.write_text("token-one")
    api = apis(P, url, token_file=str(token_file))
    api.list_nodes()
    assert state.auth_headers[-1] == "Bearer token-one"
    token_file.write_text("token-two")
    # force an mtime change even on coarse-grained filesystems
    os.utime(token_file, (time.time() + 2, time.time() + 2))
    api.list_nodes()
    assert state.auth_headers[-1] == "Bearer token-two"


@PKGS
def test_synthesized_offers_over_http(P, apiserver, apis):
    state, url = apiserver
    state.add_node("n1", 8192, 16)
    cluster = P.k8s.KubeCluster("k", apis(P, url), lambda: 0)
    cluster.launch_tasks("default", [spec(P, mem=2048, cpus=4)])
    [offer] = cluster.pending_offers("default")
    assert offer.mem == 8192 - 2048
    assert offer.cpus == 16 - 4


@PKGS
def test_full_process_schedules_onto_http_apiserver(P, apiserver):
    """The whole service (build_process with a `k8s-http` cluster) places a
    submitted job as a pod on the fake apiserver and completes it from
    watch events — no FakeKubeApi anywhere in the path."""
    state, url = apiserver
    state.add_node("n1", 8192, 16)
    settings = P.config.Settings(
        rank_interval_s=3600, match_interval_s=3600,
        clusters=[{"kind": "k8s-http", "name": "kprod", "url": url,
                   "watch_timeout_s": 5}], **P.platform)
    process = P.components.build_process(settings, start_rest=False)
    try:
        P.components.start_leader_duties(process, block=False,
                                         on_loss=lambda: None)
        job = P.ent.Job(uuid=P.ent.new_uuid(), user="alice",
                        pool="default", command="true", max_retries=1,
                        resources=P.ent.Resources(mem=512, cpus=2))
        process.store.submit_jobs([job])
        loops = {loop.name: loop for loop in process.loops}
        loops["rank"].fire()
        loops["match"].fire()
        wait_for(lambda: len(state.pods) == 1, what="pod on apiserver")
        [name] = state.pods
        state.set_phase(name, "Running")
        wait_for(lambda: process.store.jobs[job.uuid].state
                 == P.ent.JobState.RUNNING, what="job running")
        state.set_phase(name, "Succeeded")
        wait_for(lambda: process.store.jobs[job.uuid].state
                 == P.ent.JobState.COMPLETED, what="job completed")
    finally:
        P.components.shutdown(process)
        for cluster in process.clusters:
            cluster.api.stop()


@PKGS
def test_relist_prunes_stale_local_view(P, apiserver, apis):
    """A pod deleted during the gap disappears from the client's view and
    the controller observes the deletion."""
    state, url = apiserver
    state.add_node("n1", 8192, 16)
    api = apis(P, url)
    events = []
    api.set_pod_watch(lambda name, pod: events.append(
        (name, None if pod is None else pod.phase)))
    api.start()
    state.create_pod(api.pod_manifest(P.k8s.KubePod(
        name="p1", node_name="n1", mem=100, cpus=1)))
    wait_for(lambda: ("p1", P.k8s.PodPhase.PENDING) in events,
             what="added")
    state.inject_gap()
    state.delete_pod("p1")
    wait_for(lambda: ("p1", None) in events, timeout=10,
             what="deletion via re-list")


# ------------------------------- tests/test_faults.py::TestK8sRetrySplit


@pytest.fixture()
def one_node(apiserver, apis):
    state, url = apiserver
    state.add_node("n1", 8192, 16)
    return lambda P: apis(P, url)


@PKGS
def test_idempotent_get_retried_once(P, one_node):
    api = one_node(P)
    with P.faults.injected({"point": "k8s.request", "times": 1,
                            "match": {"method": "GET"}}) as s:
        [node] = api.list_nodes()  # first attempt faulted, retry won
    assert node.name == "n1"
    assert s.fired_total() == 1


@PKGS
def test_mutating_request_stays_single_shot(P, one_node):
    api = one_node(P)
    with P.faults.injected({"point": "k8s.request", "times": 1,
                            "match": {"method": "DELETE"}}) as s:
        # if DELETE were retried, the second attempt would succeed
        # and no error would surface — the raise IS the proof
        with pytest.raises(OSError):
            api.delete_pod("anything")
    assert s.fired_total() == 1


@PKGS
def test_get_retry_classification(P):
    ApiError, WatchGap = P.http.ApiError, P.http.WatchGap
    retryable = P.http._retryable_get_error
    assert retryable(OSError("conn refused"))
    assert retryable(ApiError("boom", 503))
    assert not retryable(ApiError("bad request", 400))
    assert not retryable(ApiError("not found", 404))
    assert not retryable(WatchGap("/pods"))
    assert not retryable(ValueError("bad json"))


# ------------------------------------------------- across the packages


QUANTITIES = ["0", "1", "512Mi", "2Gi", "1Ti", "3Ki", "1Pi", "1Ei",
              "1073741824", "1G", "1M", "64k", "5K", "2T", "1P", "1E",
              "1500m", "0.5Gi", 1048576, 0.0, 3]
CPUS = ["500m", "4", "0.25", "100m", "1", 2, "31999m"]


def test_quantity_parsers_equal_across_packages():
    for q in QUANTITIES:
        assert port_http.parse_mem(q) == ref_http.parse_mem(q), q
    for q in CPUS:
        assert port_http.parse_cpu(q) == ref_http.parse_cpu(q), q
    for mb in (0.0, 0.4, 0.5, 1.5, 511.7, 4096.0, 65536.25):
        assert port_http.format_mem(mb) == ref_http.format_mem(mb)


MANIFEST_SPECS = [
    dict(task_id="plain", node="n1"),
    dict(task_id="ports", node="n1", ports=(31000, 31007)),
    dict(task_id="gpu", node="n1", mem=4096.0, cpus=3.5),
    dict(task_id="ckpt", node="n1", checkpoint_mode="auto",
         checkpoint_periodic_sec=300, checkpoint_preserve_paths=("/a",)),
    dict(task_id="noimage", node="n1", container_image="", env=()),
]


def _manifests(P, url, state):
    api = P.http.HttpKubeApi(url, file_server_port=8000,
                             file_server_image="sidecar:2",
                             checkpoint_tools_image="ckpt:3",
                             default_image="base:4", namespace="cook")
    cluster = P.k8s.KubeCluster("k", api, lambda: 0)
    for pool, kw in zip(("default", "gpu", "default", "default", ""),
                        MANIFEST_SPECS):
        cluster.launch_tasks(pool, [spec(P, **kw)])
    out = {}
    for name, manifest in state.pods.items():
        manifest = {k: v for k, v in manifest.items() if k != "status"}
        manifest["metadata"] = {k: v for k, v in
                                manifest["metadata"].items()
                                if k != "resourceVersion"}
        out[name] = manifest
    out["synthetic"] = api.pod_manifest(P.k8s.KubePod(
        name="synthetic-1", node_name="", mem=100.4, cpus=0.5, gpus=1.0,
        synthetic=True, pool="gpu"))
    return out


def test_pod_manifests_equal_across_packages():
    """The same TaskSpecs launched through each package's cluster POST
    the same manifests (sidecar, ports, env, checkpoint init container
    and volume, default image, pool toleration), and a synthetic pod's
    manifest is the same too."""
    got = {}
    for P in (REF, PORT):
        server, state, url = make_server()
        try:
            got[P.name] = _manifests(P, url, state)
        finally:
            server.shutdown()
    assert set(got["port"]) == {s["task_id"] for s in MANIFEST_SPECS} | {
        "synthetic"}
    assert got["port"] == got["ref"]
    ports = got["port"]["ports"]["spec"]["containers"][0]["ports"]
    assert ports == [{"containerPort": 31000, "hostPort": 31000},
                     {"containerPort": 31007, "hostPort": 31007}]
    assert [c["name"] for c in got["port"]["plain"]["spec"]["containers"]] \
        == ["cook-job", "cook-sidecar"]


@pytest.mark.parametrize("old,new", [(REF, PORT), (PORT, REF)],
                         ids=["port-adopts-ref", "ref-adopts-port"])
def test_cluster_adopts_the_other_packages_live_pods(old, new, apiserver):
    """One package's cluster launches two pods that run; the other's,
    on the same apiserver, rebuilds its expected state from their task
    ids, then watches: neither pod is deleted as an orphan, and their
    completions reach the new cluster's status feed."""
    state, url = apiserver
    state.add_node("n1", 8192, 16)
    first = old.http.HttpKubeApi(url, watch_timeout_s=5.0)
    cluster = old.k8s.KubeCluster("k", first, lambda: 0)
    cluster.launch_tasks("default", [spec(old, "t1"), spec(old, "t2")])
    for name in ("t1", "t2"):
        state.set_phase(name, "Running")
    second = new.http.HttpKubeApi(url, watch_timeout_s=5.0,
                                  relist_backoff_s=0.05)
    try:
        adopter = new.k8s.KubeCluster("k", second, lambda: 0)
        statuses = statuses_of(adopter)
        adopter.determine_expected_state_on_startup({"t1", "t2"})
        second.start()
        wait_for(second._synced.is_set, what="watch synced")
        assert set(state.pods) == {"t1", "t2"}
        assert adopter.expected == {
            "t1": new.k8s.ExpectedState.RUNNING,
            "t2": new.k8s.ExpectedState.RUNNING}
        state.set_phase("t1", "Succeeded")
        state.set_phase("t2", "Failed", reason="OOMKilled")
        wait_for(lambda: not state.pods, what="pods deleted")
        assert sorted(statuses) == [("t1", "success", "normal-exit"),
                                    ("t2", "failed", "max-mem-exceeded")]
    finally:
        second.stop()


# ------------------------------------------------ the port's own wiring


def _k8s_settings(P, url, **kw):
    return P.config.Settings(
        rank_interval_s=3600, match_interval_s=3600,
        clusters=[{"kind": "k8s-http", "name": "kprod", "url": url,
                   "watch_timeout_s": 5}], **P.platform, **kw)


@pytest.mark.parametrize("P,deletes", [(REF, True), (PORT, False)],
                         ids=["ref", "port"])
def test_a_node_without_leadership_leaves_the_pods_alone(P, deletes,
                                                          apiserver):
    """A node that has built its process but leads nothing (a standby,
    or a restarted leader before its election): the reference's factory
    started the watch, whose first re-list hands the leader's running
    pod to a controller that expects nothing, and it deletes the pod as
    an orphan; the port watches only once it leads."""
    state, url = apiserver
    state.add_node("n1", 8192, 16)
    api = port_http.HttpKubeApi(url)
    state.create_pod(api.pod_manifest(port_k8s.KubePod(
        name="leaders-task", node_name="n1", mem=100, cpus=1)))
    state.set_phase("leaders-task", "Running")
    process = P.components.build_process(_k8s_settings(P, url),
                                         start_rest=False)
    try:
        if deletes:
            wait_for(lambda: not state.pods, what="orphan delete")
        else:
            time.sleep(0.5)
            assert set(state.pods) == {"leaders-task"}
            [cluster] = process.clusters
            assert cluster.api._watch_thread is None
    finally:
        P.components.shutdown(process)
        for cluster in process.clusters:
            cluster.api.stop()


def test_port_leader_adopts_the_running_pods_of_its_store(apiserver,
                                                          tmp_path):
    """The port's node restarted on its data_dir against the same
    apiserver: the pod its first life launched is running; the second
    life takes leadership, expects it (its store's live instance), and
    its completion completes the job."""
    state, url = apiserver
    state.add_node("n1", 8192, 16)
    data = str(tmp_path / "data")
    first = port_components.build_process(
        _k8s_settings(PORT, url, data_dir=data), start_rest=False)
    try:
        port_components.start_leader_duties(first, block=False,
                                            on_loss=lambda: None)
        job = port_ent.Job(uuid=port_ent.new_uuid(), user="alice",
                           pool="default", command="true", max_retries=1,
                           resources=port_ent.Resources(mem=512, cpus=2))
        first.store.submit_jobs([job])
        loops = {loop.name: loop for loop in first.loops}
        loops["rank"].fire()
        loops["match"].fire()
        wait_for(lambda: len(state.pods) == 1, what="pod on apiserver")
        [name] = state.pods
        state.set_phase(name, "Running")
        wait_for(lambda: first.store.jobs[job.uuid].state
                 == port_ent.JobState.RUNNING, what="job running")
    finally:
        port_components.shutdown(first)
    second = port_components.build_process(
        _k8s_settings(PORT, url, data_dir=data), start_rest=False)
    try:
        port_components.start_leader_duties(second, block=False,
                                            on_loss=lambda: None)
        [cluster] = second.clusters
        wait_for(cluster.api._synced.is_set, what="watch synced")
        assert cluster.expected == {name: port_k8s.ExpectedState.RUNNING}
        assert set(state.pods) == {name}
        state.set_phase(name, "Succeeded")
        wait_for(lambda: second.store.jobs[job.uuid].state
                 == port_ent.JobState.COMPLETED, what="job completed")
        wait_for(lambda: not state.pods, what="pod deleted")
        assert len(second.store.job_instances(job.uuid)) == 1
    finally:
        port_components.shutdown(second)


def test_port_stop_ends_a_parked_watch_at_once(apiserver):
    """A watch parked on a quiet stream (its timeout 300 s, the
    default): the port's `stop` shuts the connection, so both watch
    threads end within a second, and no event reaches the callback
    after it returns."""
    state, url = apiserver
    state.add_node("n1", 8192, 16)
    api = port_http.HttpKubeApi(url)
    events = []
    api.set_pod_watch(lambda name, pod: events.append(name))
    api.start()
    wait_for(lambda: api._synced.is_set() and api._all_synced.is_set(),
             what="watches synced")
    time.sleep(0.2)  # both streams parked
    threads = [api._watch_thread, api._all_watch_thread]
    t0 = time.monotonic()
    api.stop()
    assert time.monotonic() - t0 < 1.0
    assert not any(t.is_alive() for t in threads)
    state.create_pod(api.pod_manifest(port_k8s.KubePod(
        name="late", node_name="n1", mem=1, cpus=1)))
    time.sleep(0.2)
    assert events == [] and not [t for t in threading.enumerate()
                                 if t.name.startswith("kube-")]


def test_chip_smoke_k8s_phase_on_cpu(monkeypatch):
    """chip_smoke.py's Kubernetes phase (30) at a CPU test's size: the
    node (`python -m cook_tpu_torch` run by `chip_smoke.py --k8s-node`)
    on the CPU against a fake apiserver of 200 nodes; 300 jobs, 10 of
    them killed over REST, 5 running across the SIGTERM and reboot, one
    watch gap; every check of the phase, and the GSSAPI answer.  On the
    CPU the matcher's `best_node` calls run the plain version and count
    no launch; the kept calls come back from both node processes."""
    import tempfile

    import chip_smoke

    monkeypatch.setattr(chip_smoke, "K8S_ADOPT", 5)
    monkeypatch.setattr(chip_smoke, "K8S_ADOPT_RUNTIME_MS", 20_000)
    monkeypatch.setattr(chip_smoke, "K8S_GAP_AFTER", 30)
    monkeypatch.setattr(chip_smoke, "K8S_REBOOT_AFTER", 100)
    monkeypatch.setattr(chip_smoke, "K8S_RUNTIMES_MS", (300, 500, 1000))
    assert "401 Negotiate" in chip_smoke.gssapi_check()
    with tempfile.TemporaryDirectory() as workdir:
        launches, calls, out = chip_smoke.k8s_run(workdir, n_nodes=200,
                                                  n_jobs=300, device="cpu")
    assert launches == 0 and calls
    assert all(a.device.type == "cpu" for a in calls[0][:3])
    assert out["pods_created"] == out["jobs"] == 300
    assert out["running_at_adoption"] >= 1 and out["gone_410"] >= 1
    assert out["list_nodes_walls_s"] and out["node_cycles"]["n"] > 0
    assert out["rebooted_node_cycles"]["n"] > 0


def test_port_cluster_created_over_rest_watches_on_the_leader(apiserver,
                                                              tmp_path):
    """A `k8s-http` cluster created over POST /compute-clusters on the
    port's leader takes up its controller at once (its watch runs, its
    pod reaches the store), and the node stops with no watch left."""
    import requests

    from cook_tpu_torch.rest.server import free_port

    state, url = apiserver
    state.add_node("n1", 8192, 16)
    port = free_port()
    settings = PORT.config.Settings(
        port=port, rank_interval_s=3600, match_interval_s=3600,
        clusters=[], data_dir=str(tmp_path / "data"), **PORT.platform)
    process = port_components.build_process(settings)
    try:
        port_components.start_leader_duties(process, block=False,
                                            on_loss=lambda: None)
        r = requests.post(f"http://127.0.0.1:{port}/compute-clusters",
                          json={"name": "k2", "kind": "k8s-http",
                                "url": url, "watch_timeout_s": 5},
                          headers={"X-Cook-Requesting-User": "admin"},
                          timeout=30)
        assert r.status_code == 201, r.text
        [cluster] = process.scheduler.clusters
        wait_for(cluster.api._synced.is_set, what="watch synced")
        job = port_ent.Job(uuid=port_ent.new_uuid(), user="alice",
                           pool="default", command="true", max_retries=1,
                           resources=port_ent.Resources(mem=512, cpus=2))
        process.store.submit_jobs([job])
        loops = {loop.name: loop for loop in process.loops}
        loops["rank"].fire()
        loops["match"].fire()
        wait_for(lambda: len(state.pods) == 1, what="pod on apiserver")
        [name] = state.pods
        state.set_phase(name, "Succeeded")
        wait_for(lambda: process.store.jobs[job.uuid].state
                 == port_ent.JobState.COMPLETED, what="job completed")
    finally:
        port_components.shutdown(process)
    assert not [t for t in threading.enumerate()
                if t.name.startswith("kube-")]
