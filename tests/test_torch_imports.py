"""The PyTorch port stands alone: no module of `cook_tpu_torch`, and not
`chip_smoke.py`, imports JAX or anything of the `cook_tpu` reference, nor
aiohttp or requests (the card's machine has neither: the service and the
client tier run on the standard library); the client tier (`client`,
`executor`, `sidecar`, `integrations`) and its entry points load no
torch; and the solver's entry points refuse to run without a card unless
asked for the CPU."""
import ast
import os
import subprocess
import sys

import pytest
import torch

# one intra-op thread: the suite runs several pytest-xdist workers side
# by side, and idle OpenMP threads spinning in each would crowd them
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "cook_tpu_torch")


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top.startswith("jax") or top == "cook_tpu"


# HTTP libraries the reference serves and calls with, absent on the card's
# machine
HTTP_LIBS = ("aiohttp", "requests")


def _http_lib(name: str) -> bool:
    return name.split(".")[0] in HTTP_LIBS


def test_importing_every_port_module_loads_no_jax_or_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import cook_tpu_torch, chip_smoke\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    cook_tpu_torch.__path__, 'cook_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0].startswith('jax')\n"
        "             or m.split('.')[0] == 'cook_tpu')\n"
        "print(len(names), bad)\n"
        "assert len(names) >= 20 and not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# the modules of the rebalance and gang slices, each imported alone in a
# fresh interpreter: none may pull in JAX or the reference (jax-free copies
# of reference modules must import the port's own dependencies)
REBALANCE_MODULES = ("cook_tpu_torch.ops.rebalance",
                     "cook_tpu_torch.ops.cpu_reference",
                     "cook_tpu_torch.obs.fairness",
                     "cook_tpu_torch.utils.metrics",
                     "cook_tpu_torch.sim.loadgen",
                     "cook_tpu_torch.scheduler.rebalancer")


# the gang slice's modules, new and extended
GANG_MODULES = ("cook_tpu_torch.ops.gang",
                "cook_tpu_torch.scheduler.gang",
                "cook_tpu_torch.scheduler.matcher",
                "cook_tpu_torch.scheduler.core",
                "cook_tpu_torch.ops.hierarchical",
                "cook_tpu_torch.ops.coarse_pass",
                "cook_tpu_torch.models.store",
                "cook_tpu_torch.sim.simulator")


# the default-configuration slice's modules: copies of jax-free reference
# modules (columnar index, encode cache, flight recorder, the observatory
# modules) must import the port's own dependencies
DEFAULT_CONFIG_MODULES = ("cook_tpu_torch.models.columnar",
                          "cook_tpu_torch.scheduler.ranking_columnar",
                          "cook_tpu_torch.scheduler.encode_cache",
                          "cook_tpu_torch.scheduler.flight_recorder",
                          "cook_tpu_torch.obs.data_plane",
                          "cook_tpu_torch.obs.compile_observatory",
                          "cook_tpu_torch.obs.device_monitor",
                          "cook_tpu_torch.obs.health",
                          "cook_tpu_torch.obs.quality_monitor",
                          "cook_tpu_torch.obs.telemetry",
                          "cook_tpu_torch.sim.cli")


# the multi-pool slice's modules, new (the pipelined pass, the rate
# limiter copy) and extended (the pool-batched ops, the async launch
# fan-out, the batched telemetry)
MULTIPOOL_MODULES = ("cook_tpu_torch.scheduler.pipeline",
                     "cook_tpu_torch.scheduler.ratelimit",
                     "cook_tpu_torch.ops.match",
                     "cook_tpu_torch.ops.dru",
                     "cook_tpu_torch.ops.common",
                     "cook_tpu_torch.cluster.base",
                     "cook_tpu_torch.cluster.mock")


# the device-residency slice's modules, new (the resident state, the
# in-place updaters, the listener fan-out copy) and extended (the rank
# paths' resident columns, the kernel wrappers' bfloat16 boundary casts,
# the configuration keys)
RESIDENCY_MODULES = ("cook_tpu_torch.scheduler.device_state",
                     "cook_tpu_torch.ops.device_update",
                     "cook_tpu_torch.utils.callbacks",
                     "cook_tpu_torch.scheduler.ranking",
                     "cook_tpu_torch.ops.best_node",
                     "cook_tpu_torch.ops.best_node_batched",
                     "cook_tpu_torch.ops.best_block",
                     "cook_tpu_torch.utils.config")


# the prediction slice's modules, new (the runtime predictor and the
# speculator, a copy of a jax-free reference module) and extended (the
# speculative pipelined stage, the simulator's A/B, the CLI flags)
PREDICTION_MODULES = ("cook_tpu_torch.scheduler.prediction",
                      "cook_tpu_torch.scheduler.pipeline",
                      "cook_tpu_torch.scheduler.flight_recorder",
                      "cook_tpu_torch.sim.cli")


# the elastic slice's modules: the solve, the planner and its recorder,
# and the commit pipeline it commits through (copies of jax-free
# reference modules: txn, persistence, codec, contention, faults, tracing,
# whose device trace is torch.profiler's), and what it extends (the
# store's ledger, the mock cluster's scale)
ELASTIC_MODULES = ("cook_tpu_torch.ops.elastic",
                   "cook_tpu_torch.elastic",
                   "cook_tpu_torch.elastic.planner",
                   "cook_tpu_torch.elastic.recorder",
                   "cook_tpu_torch.txn",
                   "cook_tpu_torch.txn.log",
                   "cook_tpu_torch.txn.ops",
                   "cook_tpu_torch.txn.transaction",
                   "cook_tpu_torch.models.persistence",
                   "cook_tpu_torch.models.codec",
                   "cook_tpu_torch.obs.contention",
                   "cook_tpu_torch.faults",
                   "cook_tpu_torch.utils.tracing")


# the superblock slice's modules, new (copies of jax-free reference
# modules: the incident recorder, the metrics history, the overload
# reactions; the profile capturer on torch.profiler) and extended (the
# superblock layer, the quality audit, the fault points, the scheduler's
# wiring, the simulator's fault schedule and history)
SUPERBLOCK_MODULES = ("cook_tpu_torch.obs.incident",
                      "cook_tpu_torch.obs.profiling",
                      "cook_tpu_torch.obs.tsdb",
                      "cook_tpu_torch.faults.reactions",
                      "cook_tpu_torch.ops.hierarchical",
                      "cook_tpu_torch.scheduler.matcher",
                      "cook_tpu_torch.scheduler.core",
                      "cook_tpu_torch.cluster.base",
                      "cook_tpu_torch.sim.simulator")


# the service slice's modules: the REST layer on the standard library, the
# process wiring and its entry point, and the copies of jax-free reference
# modules they need (config, plugins, monitors, leader election, auth);
# then the control plane's: the lease service, journal replication, its
# retry policy and the replica-read rule
SERVICE_MODULES = ("cook_tpu_torch.__main__",
                   "cook_tpu_torch.components",
                   "cook_tpu_torch.rest",
                   "cook_tpu_torch.rest.api",
                   "cook_tpu_torch.rest.auth",
                   "cook_tpu_torch.rest.http",
                   "cook_tpu_torch.rest.server",
                   "cook_tpu_torch.control.leader",
                   "cook_tpu_torch.shard.router",
                   "cook_tpu_torch.utils.config",
                   "cook_tpu_torch.utils.logging",
                   "cook_tpu_torch.utils.incremental",
                   "cook_tpu_torch.scheduler.plugins",
                   "cook_tpu_torch.scheduler.queue_limit",
                   "cook_tpu_torch.scheduler.optimizer",
                   "cook_tpu_torch.scheduler.monitor",
                   "cook_tpu_torch.scheduler.progress",
                   "cook_tpu_torch.scheduler.heartbeat",
                   "cook_tpu_torch.scheduler.sandbox",
                   "cook_tpu_torch.control.lease_server",
                   "cook_tpu_torch.control.replication",
                   "cook_tpu_torch.utils.retry",
                   "cook_tpu_torch.shard.replica")


# the sharded store's modules (the router, the partitioned store, its
# commit pipeline and journal segments), which the service imports
SHARD_MODULES = ("cook_tpu_torch.shard",
                 "cook_tpu_torch.shard.store",
                 "cook_tpu_torch.shard.txn",
                 "cook_tpu_torch.shard.journal")


# the multi-process runtime's modules, the cross-process tracing and fleet
# observatory they import, and the native host solvers' binding
MP_MODULES = ("cook_tpu_torch.mp",
              "cook_tpu_torch.mp.topology",
              "cook_tpu_torch.mp.twopc",
              "cook_tpu_torch.mp.worker",
              "cook_tpu_torch.mp.router",
              "cook_tpu_torch.mp.supervisor",
              "cook_tpu_torch.obs.distributed",
              "cook_tpu_torch.obs.fleet",
              "cook_tpu_torch.ops.native",
              "cook_tpu_torch.build")


# the client tier: the job client and `cs`, the executor, the sidecar, the
# integrations (none of which may load torch either: a submit host needs
# no GPU stack), and the load generator (whose trace generators do)
CLIENT_MODULES = ("cook_tpu_torch",
                  "cook_tpu_torch.client",
                  "cook_tpu_torch.client.models",
                  "cook_tpu_torch.client.jobclient",
                  "cook_tpu_torch.client.cli",
                  "cook_tpu_torch.executor",
                  "cook_tpu_torch.executor.runner",
                  "cook_tpu_torch.sidecar",
                  "cook_tpu_torch.sidecar.fileserver",
                  "cook_tpu_torch.integrations",
                  "cook_tpu_torch.integrations.spark",
                  "cook_tpu_torch.integrations.workerpool")
LOADGEN_MODULES = ("cook_tpu_torch.sim.loadgen",
                   "cook_tpu_torch.sim.cli")


# the device mesh on torch.distributed and the rank bodies of its tests
# (which spawned ranks import); the modules that take a mesh are listed
# above
MESH_MODULES = ("cook_tpu_torch.parallel",
                "cook_tpu_torch.parallel.mesh",
                "tests.test_torch_mesh_ranks")


# the Kubernetes backend (the controller, the apiserver client on the
# standard library) and the Kerberos acceptor (ctypes)
K8S_MODULES = ("cook_tpu_torch.cluster.k8s",
               "cook_tpu_torch.cluster.k8s_http",
               "cook_tpu_torch.rest.gssapi")


@pytest.mark.parametrize("module", SERVICE_MODULES + SHARD_MODULES
                         + MP_MODULES + CLIENT_MODULES + LOADGEN_MODULES
                         + K8S_MODULES)
def test_service_module_loads_no_jax_reference_or_http_library(module):
    code = (
        "import importlib, sys\n"
        f"importlib.import_module({module!r})\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0].startswith('jax')\n"
        "             or m.split('.')[0] in ('cook_tpu', 'aiohttp',\n"
        "                                    'requests'))\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("module", CLIENT_MODULES)
def test_client_tier_module_loads_no_torch(module):
    code = (
        "import importlib, sys\n"
        f"importlib.import_module({module!r})\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('torch', 'numpy'))\n"
        "assert not bad, bad[:5]\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("module", ["cook_tpu_torch.client.cli",
                                    "cook_tpu_torch.sidecar.fileserver"])
def test_client_entry_point_help_loads_no_torch_jax_or_http_library(
        module):
    """`python -m <entry point> --help` with `-X importtime` listing each
    module it imports."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", module, "--help"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "usage:" in proc.stdout
    imported = [line.split("|")[-1].strip()
                for line in proc.stderr.splitlines()
                if line.startswith("import time:")]
    assert module in imported or module.rsplit(".", 1)[0] in imported
    bad = sorted(m for m in imported
                 if _forbidden(m) or _http_lib(m)
                 or m.split(".")[0] in ("torch", "numpy"))
    assert not bad, bad


def test_importing_every_port_module_loads_no_http_library():
    code = (
        "import importlib, pkgutil, sys\n"
        "import cook_tpu_torch, chip_smoke\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    cook_tpu_torch.__path__, 'cook_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('aiohttp', 'requests'))\n"
        "assert 'cook_tpu_torch.rest.api' in names, names\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("module", REBALANCE_MODULES + GANG_MODULES
                         + DEFAULT_CONFIG_MODULES + MULTIPOOL_MODULES
                         + RESIDENCY_MODULES + PREDICTION_MODULES
                         + ELASTIC_MODULES + SUPERBLOCK_MODULES
                         + MESH_MODULES)
def test_rebalance_slice_module_loads_no_jax_or_reference(module):
    code = (
        "import importlib, sys\n"
        f"importlib.import_module({module!r})\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0].startswith('jax')\n"
        "             or m.split('.')[0] == 'cook_tpu')\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_spawned_mesh_ranks_load_no_jax_or_reference():
    """`run_on_mesh` from a fresh interpreter: neither it nor its two
    spawned gloo ranks (which import the rank bodies of the mesh tests)
    load JAX, the reference or the test configuration."""
    code = (
        "import sys\n"
        "from cook_tpu_torch.parallel.mesh import run_on_mesh\n"
        "from tests import test_torch_mesh_ranks as ranks\n"
        "ranked = run_on_mesh(2, ranks.loaded_modules, backend='gloo',\n"
        "                     device='cpu', timeout_s=100)\n"
        "here = sorted(m for m in sys.modules\n"
        "              if m.split('.')[0].startswith('jax')\n"
        "              or m.split('.')[0] in ('cook_tpu', 'conftest'))\n"
        "assert ranked == [] and here == [], (ranked, here)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_worker_entry_point_loads_no_jax_reference_or_http_library(
        tmp_path):
    """`python -m cook_tpu_torch.mp.worker`, booted as a standby and made
    to adopt a group (every lazy import of a serving worker runs), with
    `-X importtime` listing each module it imports."""
    import json
    import signal
    import time
    import urllib.request

    ready = tmp_path / "ready.json"
    log = tmp_path / "stderr"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    with open(log, "w") as stderr:
        proc = subprocess.Popen(
            [sys.executable, "-X", "importtime", "-m",
             "cook_tpu_torch.mp.worker", "--data-dir",
             str(tmp_path / "data"), "--n-shards", "2", "--ready-file",
             str(ready)],
            cwd=REPO, env=env, stdout=subprocess.DEVNULL, stderr=stderr)
    try:
        deadline = time.monotonic() + 90
        while not ready.exists():
            assert proc.poll() is None, log.read_text()[-2000:]
            assert time.monotonic() < deadline, "worker never ready"
            time.sleep(0.05)
        describe = json.loads(ready.read_text())
        request = urllib.request.Request(
            describe["rpc_url"] + "/rpc/adopt", method="POST",
            data=json.dumps({"group": 1, "shards": [1]}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(request, timeout=60) as r:
            assert json.loads(r.read())["active"]
    finally:
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=60)
    err = log.read_text()
    assert proc.returncode == 0, err[-2000:]
    imported = [line.split("|")[-1].strip() for line in err.splitlines()
                if line.startswith("import time:")]
    assert "cook_tpu_torch.rest.api" in imported
    bad = sorted(m for m in imported
                 if _forbidden(m) or _http_lib(m))
    assert not bad, bad


def _source_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


@pytest.mark.parametrize("path", _source_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_import_statement_names_jax_or_reference(path):
    """Lazy imports inside functions count too (a module-level import
    check alone would miss them)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        assert not any(_forbidden(n) for n in names), (path, names)


@pytest.mark.parametrize("path", _source_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_import_statement_names_an_http_library(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        assert not any(_http_lib(n) for n in names), (path, names)


def test_entry_points_raise_without_a_card_unless_given_cpu(monkeypatch):
    from cook_tpu_torch import device
    from cook_tpu_torch.models.store import JobStore
    from cook_tpu_torch.scheduler.core import Scheduler
    from cook_tpu_torch.sim.simulator import SimConfig, Simulator, synth_trace

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        device.resolve()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Scheduler(JobStore(), [])
    jobs, hosts = synth_trace(5, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Simulator(jobs, hosts)
    cpu = Simulator(jobs, hosts, device="cpu").scheduler
    assert cpu.device.type == "cpu"
    # the default configuration on the CPU: columnar index, encode cache,
    # recorder and telemetry on, and no device memory stats to read
    assert cpu.columnar is not None and cpu.encode_cache is not None
    assert cpu.recorder is not None and cpu.telemetry is not None
    # the multi-pool knobs at the reference's defaults: no launch rate
    # limit, a double-buffered pipeline with async launches
    assert cpu.launch_rate_limiter is None
    assert (cpu.config.pipeline_depth, cpu.config.async_launch) == (2, True)
    # device residency and quantization off, as in the reference: no
    # resident state, no rebalancer mirror
    assert cpu.device_state is None and not cpu.config.rebalancer.resident
    # speculation and backfill off, as in the reference: no predictor, no
    # speculator; with speculation on, the speculative solve runs on the
    # scheduler's device
    assert cpu.predictor is None and cpu.speculator is None
    speculating = Simulator(jobs, hosts, SimConfig(speculate=True),
                            device="cpu").scheduler
    assert speculating.speculator.device.type == "cpu"
    assert speculating.predictor is not None
    resident = Simulator(jobs, hosts, SimConfig(resident=True),
                         device="cpu").scheduler
    assert resident.device_state.device.type == "cpu"
    assert cpu.telemetry.health()["checks"]["device_memory"] == {
        "observable": False}
    with pytest.raises(ValueError, match="unsupported device"):
        device.resolve("meta")


def test_cli_run_needs_a_card_or_device_cpu(monkeypatch, tmp_path):
    from cook_tpu_torch.sim import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    trace = str(tmp_path / "t.json")
    assert cli.main(["synth", "--jobs", "20", "--hosts", "4",
                     "--out", trace]) == 0
    run = ["run", "--trace", trace, "--chunk", "0", "--max-cycles", "3"]
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main([*run, "--out", str(tmp_path / "a.csv")])
    assert cli.main([*run, "--out", str(tmp_path / "b.csv"),
                     "--device", "cpu"]) == 0
