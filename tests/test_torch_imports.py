"""The PyTorch port stands alone: no module of `cook_tpu_torch`, and not
`chip_smoke.py`, imports JAX or anything of the `cook_tpu` reference, and
its entry points refuse to run without a card unless asked for the CPU."""
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


@pytest.mark.parametrize("module", REBALANCE_MODULES + GANG_MODULES
                         + DEFAULT_CONFIG_MODULES + MULTIPOOL_MODULES
                         + RESIDENCY_MODULES)
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
