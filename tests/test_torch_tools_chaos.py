"""The port's chaos drill (`python -m cook_tpu_torch.tools.chaos`): each of
its eight scenarios passes on the CPU, with the reference's invariants and
timing bounds; `device-fallback` is `device-error` (no CPU re-solve)."""
import pathlib
import sys

import pytest
import torch

from cook_tpu_torch.tools import chaos

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent / "tools"))

import chaos as ref_chaos  # noqa: E402

torch.set_num_threads(1)


def test_the_scenarios_are_the_references_with_device_error():
    ref = list(ref_chaos.SCENARIOS)
    assert list(chaos.SCENARIOS) == [
        "device-error" if name == "device-fallback" else name
        for name in ref]
    assert chaos.SMOKE == tuple(
        "device-error" if name == "device-fallback" else name
        for name in ref_chaos.SMOKE)
    assert set(chaos.DEVICE_SCENARIOS) <= set(chaos.SCENARIOS)


@pytest.mark.parametrize("name", list(chaos.SCENARIOS))
def test_scenario_passes_on_the_cpu(name):
    result = chaos.run_scenario(name, "cpu")
    assert result.passed, f"{name}: {result.error}"
    assert result.steps


def test_cli_lists_and_refuses_unknown_scenarios(capsys):
    assert chaos.main(["--list"]) == 0
    listed = capsys.readouterr().out.split("\n")
    assert "device-error [smoke]" in listed
    assert "failover-fsync" in listed
    assert chaos.main(["--scenario", "device-fallback"]) == 2
