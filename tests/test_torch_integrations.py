"""The framework integrations of `cook_tpu_torch` against `cook_tpu` on
the CPU.

- tests/test_integrations.py (the worker pool scaled up, placed, scaled
  down and closed) on both packages (`P` over `ref` / `port`): the
  package's `WorkerPool` and `JobClient` against the package's own
  `CookApi` on its `ServerThread`.
- The Spark cases of tests/test_spark_loadgen.py on both packages:
  `parse_master_url`, and the executor fleet's lifecycle (start, run,
  shrink, grow with fresh ids, stop) through the package's
  `SparkCookBackend` against the package's `build_process` service, the
  port's on the CPU.
- The port's `DaskCookCluster` over the same worker pool.
"""
import time
from types import SimpleNamespace

import pytest
import torch

from cook_tpu import components as ref_components
from cook_tpu.client import jobclient as ref_jobclient
from cook_tpu.cluster import mock as ref_mock
from cook_tpu.integrations import spark as ref_spark
from cook_tpu.integrations import workerpool as ref_workerpool
from cook_tpu.models import entities as ref_ent
from cook_tpu.models import store as ref_store
from cook_tpu.rest import api as ref_api
from cook_tpu.rest import server as ref_server
from cook_tpu.scheduler import core as ref_core
from cook_tpu.utils import config as ref_config
from cook_tpu_torch import components as port_components
from cook_tpu_torch.client import jobclient as port_jobclient
from cook_tpu_torch.cluster import mock as port_mock
from cook_tpu_torch.integrations import spark as port_spark
from cook_tpu_torch.integrations import workerpool as port_workerpool
from cook_tpu_torch.models import entities as port_ent
from cook_tpu_torch.models import store as port_store
from cook_tpu_torch.rest import api as port_api
from cook_tpu_torch.rest import server as port_server
from cook_tpu_torch.scheduler import core as port_core
from cook_tpu_torch.utils import config as port_config
from tests.conftest import FakeClock

torch.set_num_threads(1)

REF = SimpleNamespace(name="ref", jobclient=ref_jobclient,
                      workerpool=ref_workerpool, spark=ref_spark,
                      components=ref_components, config=ref_config,
                      mock=ref_mock, ent=ref_ent, store=ref_store,
                      api=ref_api, server=ref_server, core=ref_core,
                      kw={}, platform={})
PORT = SimpleNamespace(name="port", jobclient=port_jobclient,
                       workerpool=port_workerpool, spark=port_spark,
                       components=port_components, config=port_config,
                       mock=port_mock, ent=port_ent, store=port_store,
                       api=port_api, server=port_server, core=port_core,
                       kw={"device": "cpu"}, platform={"platform": "cpu"})
PKGS = pytest.mark.parametrize("P", [REF, PORT], ids=["ref", "port"])


@pytest.fixture(params=[REF, PORT], ids=["ref", "port"])
def server(request):
    P = request.param
    clock = FakeClock()
    store = P.store.JobStore(clock=clock)
    store.set_pool(P.ent.Pool(name="default"))
    cluster = P.mock.MockCluster(
        "mock",
        [P.mock.MockHost(node_id=f"n{i}", hostname=f"n{i}", mem=32000,
                         cpus=16) for i in range(4)],
        clock=clock)
    scheduler = P.core.Scheduler(store, [cluster], **P.kw)
    srv = P.server.ServerThread(
        P.api.CookApi(store, scheduler, P.api.ApiConfig())).start()
    srv.P, srv.store, srv.scheduler = P, store, scheduler
    yield srv
    srv.stop()


# ------------------------------------------- tests/test_integrations.py


def test_worker_pool_scale_up_down(server):
    P = server.P
    client = P.jobclient.JobClient(server.url, user="dask-user")
    pool = P.workerpool.WorkerPool(
        client,
        P.workerpool.WorkerSpec(
            command_template="worker --join {address} --cpus {cpus}",
            mem=1000, cpus=2),
        "tcp://scheduler:8786",
    )
    uuids = pool.scale(6)
    assert len(uuids) == 6
    jobs = client.query(uuids)
    assert all(j["status"] == "waiting" for j in jobs)
    assert all("tcp://scheduler:8786" in j["command"] for j in jobs)
    # all workers share one group
    groups = {g for j in jobs for g in j.get("groups", [])}
    assert len(groups) == 1

    # let the scheduler place them
    p = server.store.pools["default"]
    server.scheduler.rank_cycle(p)
    server.scheduler.match_cycle(p)
    assert pool.status() == {"running": 6}

    # scale down kills the surplus
    pool.scale(2)
    assert len(pool.worker_uuids) == 2
    status = pool.status()
    assert status.get("running") == 2

    pool.close()
    assert pool.worker_uuids == []


def test_dask_cluster_scales_and_closes(server):
    """The port's DaskCookCluster duck-type over its worker pool (the
    reference's has no test of its own)."""
    P = server.P
    client = P.jobclient.JobClient(server.url, user="dask-user")
    with P.workerpool.DaskCookCluster(
            client, scheduler_address="tcp://sched:8786") as cluster:
        cluster.scale(3)
        assert len(cluster.workers) == 3
        jobs = client.query(cluster.workers)
        assert all(j["command"].startswith("dask-worker tcp://sched:8786 "
                                           "--nthreads 2.0 --memory-limit "
                                           "4096.0MB") for j in jobs)
        cluster.scale(1)
        assert len(cluster.workers) == 1
        last = list(cluster.workers)
    assert cluster.workers == []
    assert client.query(last)[0]["status"] == "completed"


# ------------------------- tests/test_spark_loadgen.py's Spark cases


@pytest.fixture(scope="module", params=[REF, PORT], ids=["ref", "port"])
def service(request):
    P = request.param
    settings = P.config.Settings(
        port=P.server.free_port(),
        rank_interval_s=0.2, match_interval_s=0.2,
        clusters=[{"kind": "mock", "name": "m", "default_runtime_ms": 600,
                   "hosts": [{"node_id": f"h{i}", "mem": 32000, "cpus": 32}
                             for i in range(4)]}],
        **P.platform,
    )
    process = P.components.build_process(settings)
    P.components.start_leader_duties(process, block=False,
                                     on_loss=lambda: None)
    yield P, f"http://127.0.0.1:{settings.port}", process
    P.components.shutdown(process)


@PKGS
def test_parse_master_url(P):
    master = P.spark.parse_master_url("cook://alice@scheduler:12321")
    assert master.user == "alice"
    assert master.url == "http://scheduler:12321"
    assert P.spark.parse_master_url("cook://host:1").user == "spark"
    with pytest.raises(ValueError):
        P.spark.parse_master_url("spark://host:1")
    with pytest.raises(ValueError):
        P.spark.parse_master_url("cook://nohostport")


def test_spark_backend_fleet_lifecycle(service):
    P, url, process = service
    host, port = url.rsplit("//", 1)[1].split(":")
    backend = P.spark.SparkCookBackend(
        f"cook://spark-user@{host}:{port}",
        driver_url="spark://CoarseGrainedScheduler@driver:7077",
        spec=P.spark.SparkExecutorSpec(executor_cores=2, executor_mem=1024,
                                       max_cores=8),
    )
    with backend:
        # spark.cores.max=8 / executor.cores=2 -> 4 executors
        assert len(backend.executors) == 4
        client = P.jobclient.JobClient(url, user="spark-user")
        jobs = client.query(list(backend.executors.values()))
        # every executor carries a distinct id + the driver url
        ids = {j["env"]["SPARK_EXECUTOR_ID"] for j in jobs}
        assert len(ids) == 4
        assert all("--driver-url spark://CoarseGrainedScheduler@driver:7077"
                   in j["command"] for j in jobs)
        # executors run on the cluster
        deadline = time.time() + 10
        while time.time() < deadline:
            if all(s == "running"
                   for s in backend.executor_status().values()):
                break
            time.sleep(0.1)
        assert set(backend.executor_status().values()) == {"running"}

        # dynamic allocation: shrink kills the newest executors
        backend.request_total_executors(2)
        assert len(backend.executors) == 2
        assert sorted(backend.executors, key=int) == ["0", "1"]
        # grow again mints fresh ids (Spark never reuses executor ids)
        backend.request_total_executors(3)
        assert "4" in backend.executors
    # context exit killed the fleet
    assert backend.executors == {}
    listed = P.jobclient.JobClient(url, user="spark-user").list_jobs(
        "spark-user", states=("running",))
    assert not [j for j in listed if j["name"].startswith("spark-executor")]
