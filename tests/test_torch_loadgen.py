"""The HTTP load generator of `cook_tpu_torch` (`sim/loadgen.py`,
`sim.cli loadgen`) against `cook_tpu` on the CPU.

- `generate_workload`, `rest_traffic_trace` and `traffic_trace_jobs`
  return the reference's output exactly, for several seeds and sizes.
- The load-generator cases of tests/test_spark_loadgen.py on both
  packages (`P` over `ref` / `port`): the workload is deterministic, and
  `run_load` drives the package's `build_process` service (the port's on
  the CPU) until every job completed.
- `run_load`'s completion poll asks for 256 uuids a GET: the port's
  service answers it, the reference's aiohttp service answers 400 past
  194 uuids (ROADMAP Queue C), so the reference's `run_load` fails there
  once more than 194 jobs are pending.
- `python -m cook_tpu_torch.sim.cli loadgen` against the port's service
  (and the reference's against its own): exit 0 with the summary when
  every job completed and none failed, 1 when jobs were left
  uncompleted.
"""
import dataclasses
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from cook_tpu import components as ref_components
from cook_tpu.client import jobclient as ref_jobclient
from cook_tpu.rest import server as ref_server
from cook_tpu.sim import loadgen as ref_loadgen
from cook_tpu.utils import config as ref_config
from cook_tpu_torch import components as port_components
from cook_tpu_torch.rest import server as port_server
from cook_tpu_torch.sim import loadgen as port_loadgen
from cook_tpu_torch.utils import config as port_config

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

REF = SimpleNamespace(name="ref", pkg="cook_tpu", loadgen=ref_loadgen,
                      components=ref_components, config=ref_config,
                      server=ref_server, platform={})
PORT = SimpleNamespace(name="port", pkg="cook_tpu_torch",
                       loadgen=port_loadgen, components=port_components,
                       config=port_config, server=port_server,
                       platform={"platform": "cpu"})
PKGS = pytest.mark.parametrize("P", [REF, PORT], ids=["ref", "port"])

LOAD_CONFIGS = [
    dict(n_jobs=20, seed=5),
    dict(n_jobs=200, rate_per_minute=6000, n_users=4, seed=3, speedup=10.0),
    dict(n_jobs=1000, rate_per_minute=60_000, seed=11, pool="pool4",
         batch_max=20),
    dict(n_jobs=57, seed=0, runtime_ms_choices=(10, 20),
         mem_choices=(64,), cpus_choices=(0.25, 8)),
]


@pytest.mark.parametrize("kw", LOAD_CONFIGS)
def test_generate_workload_equals_the_reference(kw):
    want = ref_loadgen.generate_workload(ref_loadgen.LoadConfig(**kw))
    got = port_loadgen.generate_workload(port_loadgen.LoadConfig(**kw))
    assert got == want
    assert len(got) == kw["n_jobs"]


TRAFFIC_ARGS = [
    dict(),
    dict(duration_s=5.0, rps=200.0, seed=1),
    dict(duration_s=3.0, rps=80.0, mix=(0.5, 0.3, 0.2), n_users=3,
         burst_every_s=0.5, burst_len_s=0.2, burstiness=8.0, seed=7,
         pool="gpu"),
    dict(duration_s=2.0, rps=5.0, mix=(0.0, 1.0, 0.0), seed=2),
]


@pytest.mark.parametrize("kw", TRAFFIC_ARGS)
def test_rest_traffic_trace_and_its_jobs_equal_the_reference(kw):
    want = ref_loadgen.rest_traffic_trace(**kw)
    got = port_loadgen.rest_traffic_trace(**kw)
    assert [dataclasses.asdict(op) for op in got] == \
        [dataclasses.asdict(op) for op in want]
    assert got
    for jkw in (dict(), dict(runtime_ms=250, mem=512.0, cpus=2.0)):
        want_jobs = ref_loadgen.traffic_trace_jobs(want, **jkw)
        got_jobs = port_loadgen.traffic_trace_jobs(got, **jkw)
        assert [dataclasses.asdict(j) for j in got_jobs] == \
            [dataclasses.asdict(j) for j in want_jobs]
        assert len(got_jobs) == sum(op.kind == "submit" for op in got)


# --------------------------------- tests/test_spark_loadgen.py's cases


@PKGS
def test_workload_generation_deterministic(P):
    a = P.loadgen.generate_workload(P.loadgen.LoadConfig(n_jobs=20, seed=5))
    b = P.loadgen.generate_workload(P.loadgen.LoadConfig(n_jobs=20, seed=5))
    assert [s for _, s in a] == [s for _, s in b]
    offsets = [t for t, _ in a]
    assert offsets == sorted(offsets)


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


def test_loadgen_against_live_service(service):
    P, url, process = service
    config = P.loadgen.LoadConfig(n_jobs=40, rate_per_minute=6000,
                                  n_users=4, seed=3, speedup=10.0)
    report = P.loadgen.run_load(url, config, wait_timeout_s=60)
    summary = report.summary()
    assert summary["submitted"] == 40
    assert summary["completed"] == 40
    assert summary["failed"] == 0
    assert summary["submit_ms_p50"] is not None
    assert summary["schedule_ms_p50"] is not None


def _loadgen(P, url, *args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(
        [sys.executable, "-m", f"{P.pkg}.sim.cli", "loadgen", "--url", url,
         *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)


def test_sim_cli_loadgen_exit_codes(service, tmp_path):
    """`python -m <package>.sim.cli loadgen` against the package's
    service: 0 when every job completed and none failed, else 1."""
    P, url, process = service
    out = str(tmp_path / "summary.json")
    done = _loadgen(P, url, "--jobs", "30", "--rate", "6000", "--users",
                    "3", "--seed", "4", "--speedup", "10", "--out", out)
    assert done.returncode == 0, done.stderr
    summary = json.loads(done.stdout.strip().splitlines()[-1])
    with open(out) as f:
        assert summary == json.load(f)
    assert summary["submitted"] == summary["completed"] == 30
    assert summary["failed"] == 0
    # no time to wait: nothing is seen completed, so the run fails
    left = _loadgen(P, url, "--jobs", "5", "--rate", "6000", "--seed", "9",
                    "--wait-timeout-s", "0")
    assert left.returncode == 1, left.stderr
    summary = json.loads(left.stdout.strip().splitlines()[-1])
    assert summary["submitted"] == 5 and summary["completed"] < 5


def test_run_load_poll_batch_against_each_service(service):
    """`run_load` polls 256 uuids a GET (`sim/loadgen.py`).  The port's
    server reads a 64 KiB request line and answers; aiohttp reads 8,190
    bytes, so the reference's service answers 195 uuids 400."""
    P, url, process = service
    client = P.loadgen.JobClient(url, user="poller")
    uuids = client.submit([{"command": "true", "mem": 64, "cpus": 0.1,
                            "expected_runtime": 100}] * 256)
    assert len(client.query(uuids[:194])) == 194
    if P is PORT:
        assert [j["uuid"] for j in client.query(uuids)] == uuids
    else:
        with pytest.raises(ref_jobclient.JobClientError) as e:
            client.query(uuids[:195])
        assert e.value.status == 400
